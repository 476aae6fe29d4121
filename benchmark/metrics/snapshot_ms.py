"""The output layer: the seconds in ``write_gso_output`` (the native
``gso_N.out`` writer) and ``write_state_sidecar`` (the ``.npz`` sidecar),
as the farm and the runner call them, after the states' copy to the host,
over the snapshots written."""

NAME = "snapshot_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "output layer"
MOVES = "poses_per_s"
WRAPS = [
    ("lightdock_tpu_torch.parallel.multihost", "write_gso_output", "snapshot_text"),
    ("lightdock_tpu_torch.parallel.multihost", "write_state_sidecar", "snapshot_sidecar"),
    ("lightdock_tpu_torch.engine.runner", "write_gso_output", "snapshot_text"),
    ("lightdock_tpu_torch.engine.runner", "write_state_sidecar", "snapshot_sidecar"),
]


def read(run):
    count = run.span_count("snapshot_text")
    if not count:
        return None
    return 1e3 * (run.span_s("snapshot_text") + run.span_s("snapshot_sidecar")) / count
