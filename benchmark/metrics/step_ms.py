"""The farm's (or the runner's) GSO step: the seconds of the jobs'
segments (``--metrics``: steps, the copy of the states to the host and
the snapshot writes, ended by a synchronize) less the writer's spans, over
the steps."""

NAME = "step_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "farm, runner and GSO step"
MOVES = "poses_per_s"
WRAPS = [
    ("lightdock_tpu_torch.parallel.multihost", "write_gso_output", "snapshot_text"),
    ("lightdock_tpu_torch.parallel.multihost", "write_state_sidecar", "snapshot_sidecar"),
    ("lightdock_tpu_torch.engine.runner", "write_gso_output", "snapshot_text"),
    ("lightdock_tpu_torch.engine.runner", "write_state_sidecar", "snapshot_sidecar"),
]


def read(run):
    jobs = [j for j in run.done if j.get("segments")]
    steps = sum(j["steps"] for j in jobs)
    if not steps:
        return None
    writes = run.span_s("snapshot_text") + run.span_s("snapshot_sidecar")
    return 1e3 * (sum(sum(j["segments"]) for j in jobs) - writes) / steps
