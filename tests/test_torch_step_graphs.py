"""The runner's steps replayed from CUDA graphs, as far as the CPU can show
them: where the runner takes graphs (``engine.runner.use_graphs``), the
counters and launches each replay adds (``ReplayCounts``), and the
runner's bookkeeping around the replays (the first step of a call op by op,
the state copied into the static buffers, each step's row of the outputs,
the snapshots, a resume, a reset) with a stand-in graph whose replay runs
the captured Python again.  The graphs themselves run on the card:
``tests/test_torch_cuda.py -k graphed``.

    python -m pytest tests/test_torch_step_graphs.py -q
"""

import contextlib
import types
from unittest import mock

import pytest
import torch

from lightdock_tpu_torch.engine import runner as runner_mod
from lightdock_tpu_torch.engine.runner import GsoTorchRunner, counted_once, use_graphs
from lightdock_tpu_torch.standin import toy_system
from lightdock_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("device,mode,graphs", [
    ("cuda", "kernel", True), ("cuda:0", "kernel_v1", True), ("cuda", "dense", False),
    ("cpu", "kernel", False), ("cpu", "kernel_v1", False), ("cpu", "dense", False),
    (torch.device("cuda", 1), "kernel", True),
])
def test_graphs_where_the_card_runs_a_kernel_mode(device, mode, graphs):
    assert use_graphs(device, mode) is graphs


@pytest.mark.parametrize("recording", [True, False])
def test_replay_counts_add_each_replay(recording):
    """What the captured code counted, counted again by every replay from
    the buffers as that replay left them, and the wrappers' launches a
    replay each; the capture itself counts nothing."""
    mask = torch.zeros(8, dtype=torch.bool)
    counts = torch.zeros((3, 2), dtype=torch.int32)
    k1, cull = types.SimpleNamespace(launches=5), types.SimpleNamespace(launches=7)

    def body():
        if metrics.recording():
            metrics.count("poses_scored", mask)
            metrics.count("cull_checked", counts[:, 0])
            metrics.count("cull_kept", counts[:, 1])
        k1.launches += 1
        cull.launches += 1
        return "scores"

    tracing = metrics.record() if recording else contextlib.nullcontext()
    expected = {"poses_scored": 3, "cull_checked": 0, "cull_kept": 0}
    with tracing as rec:
        metrics.count("poses_scored", 3)   # an eager step's, kept as it is
        out, replay = counted_once(body, (k1, cull))
        assert out == "scores" and (k1.launches, cull.launches) == (5, 7)
        for step in range(4):
            # Each replay overwrites the buffers the capture counted.
            mask.copy_(torch.arange(8) < step + 2)
            counts.copy_(torch.tensor([[step, 1], [2 * step, step], [1, 0]]))
            replay.replayed()
            expected["poses_scored"] += step + 2
            expected["cull_checked"] += 3 * step + 1
            expected["cull_kept"] += step + 1
        totals = rec.take()[1] if recording else None
    assert (k1.launches, cull.launches) == (9, 11)
    assert totals == (expected if recording else None)
    assert len(replay.counted) == (3 if recording else 0)


def test_every_launch_counting_wrapper_is_registered():
    """Each wrapper of ``ops`` that counts its launches lists itself where it
    is defined, and ``counted_once`` hands what a capture launched through
    any of them to the replays without being told which."""
    from lightdock_tpu_torch import ops
    from lightdock_tpu_torch.ops import (cull, dfire_pairs, dfire_pairs_v1, elec_vdw_pairs,
                                         elec_vdw_pairs_v1, probes)
    modules = (cull, dfire_pairs, dfire_pairs_v1, elec_vdw_pairs, elec_vdw_pairs_v1, probes)
    counting = {f for m in modules for f in vars(m).values()
                if callable(f) and hasattr(f, "launches")}
    assert len(counting) == 9 and counting == set(ops.LAUNCH_COUNTED)
    k3, culls = elec_vdw_pairs.elec_vdw_pairs, cull.cull_tile_bits
    before = (k3.launches, culls.launches)

    def body():
        k3.launches += 1
        culls.launches += 1

    _, replay = counted_once(body)
    assert (k3.launches, culls.launches) == before
    replay.replayed()
    replay.replayed()
    assert (k3.launches, culls.launches) == (before[0] + 2, before[1] + 2)
    k3.launches, culls.launches = before


def test_capture_keeps_the_block_apart():
    """``metrics.capture`` gives the block a recorder of its own where one
    that keeps is active, none elsewhere, and restores the outer one."""
    with metrics.capture() as rec:
        assert rec is None and not metrics.recording()
    with metrics.record() as outer:
        with metrics.capture() as rec:
            assert rec is not outer and metrics.recording()
            metrics.count("poses_scored", 4)
            with metrics.span("anm_pose"):
                pass
        assert rec.counters == {"poses_scored": [4]} and [s[0] for s in rec.spans] == ["anm_pose"]
        assert outer.take() == ([], {})
    with metrics.record(store=False, profile=True):
        with metrics.capture() as rec:
            assert rec is None


class _Graph:
    """``torch.cuda.CUDAGraph`` on the CPU: its replay runs the captured
    Python again (kept out of the totals, as a replay runs none) and writes
    what it returns and counts into the tensors that the capture returned
    and counted, as a replay writes the graph's own buffers."""

    def replay(self):
        with metrics.capture() as rec:
            out = self.body()
        for old, new in zip(_flat(self.out), _flat(out)):
            old.copy_(new)
        for old, new in zip(self.counted, _counted(rec, {})):
            old.copy_(new)


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


def _counted(rec, before):
    """The values counted into ``rec`` after ``before`` (name -> how many)."""
    if rec is None:
        return []
    return [v for name, values in rec.counters.items() for v in values[before.get(name, 0):]]


def _captured(graph, pool, stream, body):
    rec = metrics._active
    before = {name: len(v) for name, v in rec.counters.items()} if rec else {}
    graph.out = body()
    graph.body, graph.counted = body, _counted(rec, before)
    return graph.out


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The runner's CUDA calls stood in for on the CPU."""
    monkeypatch.setattr(runner_mod, "_captured", _captured)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())


SYSTEMS = {"dfire": dict(n_rec=90, n_lig=40, g=24),
           "dna_anm": dict(n_rec=70, n_lig=30, g=24, num_anm=2, method="dna")}


def _runner(system, out_dir=None, mode="kernel", graphs=True):
    """A runner on the CPU; with ``graphs`` one that takes them there."""
    params, pos, num_anm = toy_system(**SYSTEMS[system], seed=3)
    rule = (lambda device, m: True) if graphs else use_graphs
    with mock.patch.object(runner_mod, "use_graphs", rule):
        return GsoTorchRunner(params, pos, seed=9, use_anm=num_anm > 0, anm_rec=num_anm,
                              anm_lig=num_anm, output_directory=out_dir, device="cpu",
                              energy_mode=mode)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mode", ["kernel", "kernel_v1"])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_replayed_runner_matches_eager(tmp_path, stand_in_graphs, system, mode):
    """``run_segmented`` with replays against the runner op by op: the same
    states, outputs, snapshot files and counters, 29 ``graph_steps`` in 30
    steps; a resume from the step-20 sidecar and ``run`` after a reset end
    on the same bits."""
    eager = _runner(system, str(tmp_path / "eager"), mode, graphs=False)
    graphed = _runner(system, str(tmp_path / "graphed"), mode)
    runs = []
    for r in (eager, graphed):
        with metrics.record() as rec:
            final, outs = r.run_segmented(30, 10)
            runs.append((final, outs, rec.take()[1]))
    (want, want_outs, want_counts), (got, got_outs, got_counts) = runs
    assert graphed._graphs is not None and eager._graphs is None
    assert _equal(got, want) and _equal(got_outs, want_outs)
    assert got_counts.pop("graph_steps") == 29 and got_counts == want_counts
    for name in [f"gso_{s}.out" for s in (1, 10, 20, 30)]:
        assert ((tmp_path / "graphed" / name).read_bytes()
                == (tmp_path / "eager" / name).read_bytes())

    resumed = _runner(system, str(tmp_path / "resumed"), mode)
    resumed.load_snapshot(tmp_path / "graphed" / "gso_20.out")
    assert _equal(resumed.run_segmented(30, 10)[0], want)
    graphed.reset()
    assert _equal(graphed.run(30)[0], want)


def test_recorder_started_later_captures_again(stand_in_graphs):
    """Graphs captured without a recorder count nothing: a run under one
    captures them again, and its replays count."""
    r = _runner("dfire")
    r.run_segmented(10, 5)
    first = r._graphs
    with metrics.record() as rec:
        r.run_segmented(20, 5)
        counters = rec.take()[1]
    assert r._graphs is not first and counters["graph_steps"] == 9


def test_release_drops_the_graphs(stand_in_graphs):
    """``release`` drops a runner's graphs; its next run captures them again
    and ends on the bits of a runner that kept its own."""
    kept, released = _runner("dfire"), _runner("dfire")
    kept.run_segmented(20, 5)
    released.run_segmented(10, 5)
    released.release()
    assert released._graphs is None
    assert _equal(released.run_segmented(20, 5)[0], kept.state)
    assert released._graphs is not None
