"""Host-facing GSO runner on torch.

Port of ``lightdock_tpu/engine/gso_jax.py`` ``GsoJaxRunner``: the random
stream (the host-side rand-0.7 stream, or a native one made on the device),
the energy modes, ``run``, ``run_segmented`` with its metrics hook,
``reset``, ``load_snapshot`` from a ``.npz`` sidecar or the text of a
``gso_N.out``, and the ``gso_N.out`` snapshots with their sidecars
(``utils.output``), with ANM coefficients when ``use_anm``.  The energy
modes (:func:`make_energy`) are 'kernel' (JAX's 'pallas': the v2 kernels
of ``engine.energy_kernel``), 'kernel_v1' ('pallas_v1': K4 and K5),
'dense' ('xla': ``energy_dense.batch_energy_chunked``) and 'auto', which
:func:`pick_energy_mode` (port of ``gso_jax.py``'s) resolves from a
crossover map measured on an H100 and the poses of one energy call.  A kernel runs on the card (the
default device); where the caller asks for the CPU, its plain version
runs instead.  ``energy_dtype`` scores at another dtype than the swarm state
(:func:`mixed_precision_energy`, port of ``gso_jax.py``'s): a float64
swarm scored by the float32 kernels, or a float32 swarm by the float64
dense energy.  On the card in a kernel mode (:func:`use_graphs`) the runner
replays its steps from CUDA graphs (:class:`StepGraphs`): each ``run`` and
``run_segmented`` call runs its first step op by op and every later one as
one copy of its row of draws and two replays.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from ..ops import LAUNCH_COUNTED
from ..utils import metrics
from ..utils.metrics import end as end_span
from ..utils.output import (read_gso_output, read_state_sidecar,
                            write_gso_output, write_state_sidecar)
from ..utils.positions import split_positions
from ..utils.rng import uniform_f64_stream
from .energy_dense import batch_energy_chunked
from .energy_kernel import kernel_params, make_kernel_energy_fn
from . import gso
from .gso import StepOutput, SwarmState, init_state, run_swarm
from .params import BatchScoringParams, ensure_dfire_steps, torch_params

ENERGY_MODES = ("auto", "kernel", "kernel_v1", "dense")
RNG_MODES = ("reference", "native")

log = logging.getLogger(__name__)

# The crossover map, measured on an NVIDIA H100 80GB HBM3, 700.00 W by
# ``python -m lightdock_tpu_torch.bench --crossover``: 50 steps (fewer
# where the dense runs would pass 20 s), each mode's fastest of 5 or 7
# runs, the modes in turns.  Each row: point, method, receptor ANM,
# receptor and ligand atoms, poses a call, whether the kernel mode's steps
# were replayed from CUDA graphs, and the kernel mode's poses/s over the
# dense mode's, lowest and highest over the runs.  Op by op, one swarm of
# 200 glowworms (``GsoTorchRunner`` before its graphs, as a farm's call of
# 200 poses still runs): seven runs of the map in three calls, each on its
# own machine (1ppe r700 anm, 1czy dna, 1azp l221 anm: four runs in two;
# 1czy: five in two).  Farms of 2 and 32 swarms (``--swarms``): one run in
# one call, a second of the 32-swarm 1ppe r200 point in another, and a
# third of it with a second of the 2-swarm 1czy DNA point later, after
# the cull kernel (``chip_smoke.py`` phase 26).
# Replayed, one swarm of 200 (``GsoTorchRunner`` on the card): two runs
# of the map in one call.
CROSSOVER_MAP = (
    ("1ppe r200", "dfire", False, 200, 221, 200, False, 0.756, 0.978),
    ("1czy", "dfire", False, 1281, 53, 200, False, 0.800, 1.236),
    ("1ppe r340", "dfire", False, 340, 221, 200, False, 0.937, 1.320),
    ("1ppe r700", "dfire", False, 700, 221, 200, False, 1.565, 2.520),
    ("1ppe r1100", "dfire", False, 1100, 221, 200, False, 2.506, 4.050),
    ("1ppe", "dfire", False, 1615, 221, 200, False, 3.918, 5.770),
    ("1k4c", "dfire", False, 3413, 3268, 200, False, 95.07, 153.8),  # dense over 4-6 steps
    ("1ppe r200 anm", "dfire", True, 200, 221, 200, False, 0.737, 0.975),
    ("1czy anm", "dfire", True, 1281, 53, 200, False, 0.785, 1.039),
    ("1ppe r700 anm", "dfire", True, 700, 221, 200, False, 1.400, 1.816),
    ("1ppe anm", "dfire", True, 1615, 221, 200, False, 3.210, 5.013),
    ("2uuy anm", "dfire", True, 1615, 415, 200, False, 5.850, 8.149),
    ("1615x650 anm", "dfire", True, 1615, 650, 200, False, 9.826, 13.26),
    ("1czy dna", "dna", False, 1281, 53, 200, False, 0.605, 0.638),
    ("1czy dna anm", "dna", True, 1281, 53, 200, False, 0.584, 0.689),
    ("1azp l221 anm", "dna", True, 1094, 221, 200, False, 0.811, 1.088),
    ("1azp", "dna", False, 1094, 506, 200, False, 1.863, 2.229),
    ("1azp anm", "dna", True, 1094, 506, 200, False, 1.622, 2.235),
    ("1azp pydock anm", "pydock", True, 1094, 506, 200, False, 1.688, 2.356),
    ("1ppe r200", "dfire", False, 200, 221, 400, False, 0.899, 0.899),
    ("1czy", "dfire", False, 1281, 53, 400, False, 1.008, 1.008),
    ("1czy anm", "dfire", True, 1281, 53, 400, False, 0.904, 0.904),
    ("1czy dna", "dna", False, 1281, 53, 400, False, 0.678, 0.799),
    ("1azp l221 anm", "dna", True, 1094, 221, 400, False, 1.150, 1.150),
    ("1ppe r200", "dfire", False, 200, 221, 6400, False, 9.611, 18.41),
    ("1czy", "dfire", False, 1281, 53, 6400, False, 17.67, 17.67),
    ("1ppe", "dfire", False, 1615, 221, 6400, False, 97.09, 97.09),
    ("1ppe r200 anm", "dfire", True, 200, 221, 6400, False, 10.92, 10.92),
    ("1czy anm", "dfire", True, 1281, 53, 6400, False, 16.28, 16.28),
    ("1czy dna", "dna", False, 1281, 53, 6400, False, 6.326, 6.326),
    ("1czy dna anm", "dna", True, 1281, 53, 6400, False, 6.393, 6.393),
    ("1azp l221 anm", "dna", True, 1094, 221, 6400, False, 19.48, 19.48),
    ("1ppe r200", "dfire", False, 200, 221, 200, True, 4.637, 4.735),
    ("1czy", "dfire", False, 1281, 53, 200, True, 6.16, 6.33),
    ("1ppe r340", "dfire", False, 340, 221, 200, True, 6.305, 6.548),
    ("1ppe r700", "dfire", False, 700, 221, 200, True, 11.04, 11.54),
    ("1ppe r1100", "dfire", False, 1100, 221, 200, True, 17.21, 17.41),
    ("1ppe", "dfire", False, 1615, 221, 200, True, 23.27, 24.79),
    ("1k4c", "dfire", False, 3413, 3268, 200, True, 236.4, 242.3),  # dense over 4 steps
    ("1ppe r200 anm", "dfire", True, 200, 221, 200, True, 4.576, 4.873),
    ("1czy anm", "dfire", True, 1281, 53, 200, True, 5.306, 5.416),
    ("1ppe r700 anm", "dfire", True, 700, 221, 200, True, 9.646, 9.76),
    ("1ppe anm", "dfire", True, 1615, 221, 200, True, 18.74, 19.91),
    ("2uuy anm", "dfire", True, 1615, 415, 200, True, 32.31, 32.69),
    ("1615x650 anm", "dfire", True, 1615, 650, 200, True, 45.48, 45.65),
    ("1czy dna", "dna", False, 1281, 53, 200, True, 3.451, 3.937),
    ("1azp", "dna", False, 1094, 506, 200, True, 12.68, 12.78),
    ("1czy dna anm", "dna", True, 1281, 53, 200, True, 3.899, 4.998),
    ("1azp l221 anm", "dna", True, 1094, 221, 200, True, 5.269, 5.47),
    ("1azp anm", "dna", True, 1094, 506, 200, True, 10.07, 10.33),
    ("1azp pydock anm", "pydock", True, 1094, 506, 200, True, 10.38, 10.42),
)
# Op by op, the kernel path of one swarm is bound by its host launches,
# so its poses/s moves with the host (1.1-1.9x between runs of one
# point); the dense mode is bound by the device from about 70k pairs and
# moves by a few per cent.  A call of the kernel modes scores every pose
# at one set of launches, while the dense mode's device time grows with
# poses x pairs, so the crossover is one of pair-poses a call.  At 400
# poses a call the picks at the thresholds lose by at most 1.112x; at
# 6,400 (a 32-swarm farm) the kernel wins everywhere, by 6.3x at
# 1czy-sized DNA and 9.6x at 44.2k DFIRE.  For 200 poses, DFIRE with a
# rigid receptor crosses between 44k and 75k pairs, DFIRE with a receptor
# ANM between 68k and 155k, DNA and PYDOCK (rigid or ANM: their dense
# energy has no step loop, and K3's wrapper costs the host more) between
# 242k and 554k.  A lead below CROSSOVER_TIE (the spread between runs)
# goes to the kernel, but at 242k elec/vdw, where the modes tie on a fast
# host and the kernel alone slows on a slow one, to dense.  At 1czy's
# size with a rigid receptor each mode led by more than the tie in some
# run: no threshold holds it.  Replayed, the kernel path's step is the
# card's own work (0.7-1.0 ms at the 1ppe and 1azp sizes), while the
# dense mode still launches op by op: the kernel led at every point, by
# 3.45x at 1czy-sized DNA (where dense led most op by op) to 242x at
# 1k4c, so one swarm takes the kernel at every size (none is measured
# below 44,200 pairs).  The stand-ins do not cull (every
# tile pair is active), so on real geometry the kernel's advantage is
# understated.
CROSSOVER_TIE = 1.2
KERNEL_AUTO_MIN_PAIR_POSES = 60_000 * 200             # DFIRE, rigid receptor
KERNEL_AUTO_DFIRE_ANM_MIN_PAIR_POSES = 100_000 * 200  # DFIRE, receptor ANM
KERNEL_AUTO_ELEC_VDW_MIN_PAIR_POSES = 300_000 * 200   # DNA and PYDOCK


def pick_energy_mode(params: BatchScoringParams, device, n_poses: int,
                     replayed: bool = False) -> str:
    """Resolve energy_mode='auto' from the crossover map above: 'dense' off
    a CUDA device, as JAX's returns 'xla' off a TPU; 'kernel' where the
    caller replays the kernel mode's steps from CUDA graphs (``replayed``:
    ``GsoTorchRunner``, :func:`use_graphs`), which led at every point of
    the map; else 'kernel' where the receptor x ligand atom pairs times
    ``n_poses``, the poses of one energy call, reach the threshold for the
    method and whether the receptor has ANM, and 'dense' below it.  Never
    'kernel_v1'.  A pure function of its arguments: it reads the device's
    type and touches no CUDA state."""
    if torch.device(device).type != "cuda":
        return "dense"
    if replayed:
        return "kernel"
    pair_poses = params.rec_coords.shape[0] * params.lig_coords.shape[0] * n_poses
    rec_anm = params.use_anm and params.rec_nmodes.shape[0] > 0
    if params.method != "dfire":
        threshold = KERNEL_AUTO_ELEC_VDW_MIN_PAIR_POSES
    elif rec_anm:
        threshold = KERNEL_AUTO_DFIRE_ANM_MIN_PAIR_POSES
    else:
        threshold = KERNEL_AUTO_MIN_PAIR_POSES
    return "kernel" if pair_poses >= threshold else "dense"


def resolve_energy_mode(params: BatchScoringParams, energy_mode: str, device,
                        n_poses: int, who: str, replayed: bool = False) -> str:
    """``energy_mode`` checked, with 'auto' resolved by
    :func:`pick_energy_mode` for ``n_poses`` poses a call (``replayed``
    where ``who`` replays a kernel mode's steps from CUDA graphs), logged
    at INFO for ``who`` (once a runner)."""
    if energy_mode not in ENERGY_MODES:
        raise ValueError(f"energy_mode must be one of {ENERGY_MODES}, got "
                         f"{energy_mode!r}")
    if energy_mode != "auto":
        log.info("%s: energy mode %s", who, energy_mode)
        return energy_mode
    mode = pick_energy_mode(params, device, n_poses, replayed)
    log.info("%s: energy mode %s (auto, %d poses a call)", who, mode, n_poses)
    return mode


def cuda_device(device, who: str) -> torch.device:
    """``device`` as a torch device; raises for a GPU that torch does not
    see (no fallback to the CPU).  Turns TF32 off: it would move pairs
    across DFIRE bin edges and loosen the cull bounds."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on a CUDA GPU unless given "
                           "device='cpu', and torch sees none")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def make_energy(params: BatchScoringParams, energy_mode: str, device,
                dtype: torch.dtype, energy_chunk: int = 0, dq_bf16: bool = False,
                cull: bool = True):
    """(tensor params, energy_fn) of an energy mode (see the module
    docstring).  Each mode takes the DFIRE tables it reads from any form of
    ``params``: the kernel modes through ``kernel_params``, the dense mode
    the step form at float32 (as JAX's 'xla' mode reads it there) and the
    gather at float64.  ``energy_chunk`` > 0 caps the poses of one dense
    call; the kernel modes ignore it and score every pose in one call, as
    JAX's Pallas paths do.  ``dq_bf16`` stores the DFIRE step tables in
    bfloat16 where the mode reads them ('kernel_v1', 'dense' at float32);
    each value is upcast before it is added.  ``cull`` False gives the
    kernel modes every tile of every pose (``make_kernel_energy_fn``); the
    dense mode has no cull and ignores it, as JAX's 'xla' mode does.
    'auto' is resolved before, by :func:`resolve_energy_mode`."""
    if energy_mode not in ENERGY_MODES[1:]:
        raise ValueError(f"make_energy takes one of {ENERGY_MODES[1:]}, got "
                         f"{energy_mode!r}")
    if energy_mode == "dense":
        if dtype == torch.float32:
            params = ensure_dfire_steps(params)
        energy_fn = functools.partial(batch_energy_chunked, chunk=energy_chunk)
    else:
        kernel = "v1" if energy_mode == "kernel_v1" else "v2"
        params = kernel_params(params, kernel)
        energy_fn = make_kernel_energy_fn(params, device, dtype, cull=cull,
                                          kernel=kernel)
    tparams = torch_params(params, device, dtype)
    if dq_bf16 and tparams.dfire_dq is not None:
        tparams = dataclasses.replace(
            tparams, dfire_dq=tparams.dfire_dq.to(torch.bfloat16))
    return tparams, energy_fn


def mixed_precision_energy(energy_fn, state_dtype: torch.dtype,
                           energy_dtype: Optional[torch.dtype]):
    """``energy_fn`` scoring at ``energy_dtype`` while the swarm state stays
    at ``state_dtype``: the poses and ``prev_scoring`` are cast to
    ``energy_dtype``, ``moved`` passes through, and the scores are cast
    back.  ``energy_fn`` itself where the dtypes agree or ``energy_dtype``
    is None.  The wrapped function takes ``params`` at ``energy_dtype``.

    Port of ``lightdock_tpu/engine/gso_jax.py`` ``mixed_precision_energy``.
    An unmoved pose's stored score passes through ``energy_dtype``, as in
    JAX: a float64 score keeps only its float32 bits under a float32
    energy."""
    if energy_dtype is None or energy_dtype == state_dtype:
        return energy_fn

    def wrapped(p, t, q, a_rec, a_lig, moved=None, prev_scoring=None):
        kw = {}
        if moved is not None:
            kw["moved"] = moved
        if prev_scoring is not None:
            kw["prev_scoring"] = prev_scoring.to(energy_dtype)
        scores = energy_fn(p, t.to(energy_dtype), q.to(energy_dtype),
                           a_rec.to(energy_dtype), a_lig.to(energy_dtype), **kw)
        return scores.to(state_dtype)

    wrapped.kernel = getattr(energy_fn, "kernel", None)
    return wrapped


def native_stream(seed: int, device, n: int) -> torch.Tensor:
    """(n,) float32 uniform draws in [0, 1) from ``torch.Generator`` on
    ``device`` seeded with ``seed``.  Its contract is determinism (the same
    seed, device and n give the same draws, and a stream of n draws begins
    with the stream of fewer) and range, not equality with JAX's threefry
    stream nor with the reference's rand-0.7 stream."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=gen, dtype=torch.float32, device=device)


def use_graphs(device, energy_mode: str) -> bool:
    """Whether ``GsoTorchRunner`` replays its steps from CUDA graphs: on a
    CUDA device in a kernel mode, whose step is a few hundred small
    launches that keep the card waiting on the host.  The dense mode and
    the CPU run op by op.  A pure function of its arguments."""
    return torch.device(device).type == "cuda" and energy_mode in ("kernel", "kernel_v1")


class ReplayCounts:
    """What code captured into a CUDA graph counted, for each replay to
    count again.  The captured Python runs once, at capture: there
    ``metrics.count`` is handed buffers that every replay overwrites, and
    each kernel wrapper adds its one launch.  ``counted`` holds the
    (counter, value) pairs counted at capture, ``launches`` the (wrapper,
    launches) pairs."""

    def __init__(self, counted, launches):
        self.counted, self.launches = counted, launches

    def replayed(self) -> None:
        """Count one replay: a copy of each counted tensor (``metrics.count``
        keeps what it is given, and the next replay overwrites the buffer)
        and each wrapper's launches."""
        for name, value in self.counted:
            metrics.count(name, value.clone())
        for wrapper, n in self.launches:
            wrapper.launches += n


def counted_once(body, wrappers=LAUNCH_COUNTED):
    """``(body(), ReplayCounts)``: ``body`` run once, with what it counts
    (``metrics.count`` while a recorder is active, and the ``launches`` of
    ``wrappers``: by default every wrapper that counts them,
    ``ops.LAUNCH_COUNTED``) kept out of the totals and handed to the
    replays."""
    before = [w.launches for w in wrappers]
    with metrics.capture() as rec:
        out = body()
    launches = [(w, w.launches - n) for w, n in zip(wrappers, before) if w.launches != n]
    for w, n in zip(wrappers, before):
        w.launches = n
    counted = [] if rec is None else [(name, v) for name, values in rec.counters.items()
                                      for v in values]
    return out, ReplayCounts(counted, launches)


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The side stream of every capture on ``device``.  One a device, not
    one a capture: cuBLAS keeps a workspace (32 MiB on an H100) for each
    stream it has run on, for the life of the process."""
    return torch.cuda.Stream(device=device)


def _captured(graph, pool, stream, body):
    """``body()``, its launches captured into ``graph`` on ``stream``, its
    allocations from ``pool``."""
    with torch.cuda.stream(stream):
        graph.capture_begin(pool)
        try:
            return body()
        finally:
            graph.capture_end()


class StepGraphs:
    """A runner's GSO step as two CUDA graphs sharing one memory pool: the
    scores (``gso.gso_energy``) and the move (``gso.gso_move``, then the new
    state written back over the state it read).  Both read static buffers:
    ``state``, and ``randoms``, the step's row of draws.  The code captured
    is the step's own, its kernels the hand-written ones.  Capture it once
    the step has run op by op on the device (cuBLAS's handle and the
    kernels' settings are made then), and while a recorder is active if
    the replays are to count (``recording``).  The pool (about 25 MB at the
    1ppe and 1azp sizes) goes back to the caching allocator once the graphs
    are gone, and to the card only when the cache is emptied."""

    def __init__(self, params, state: SwarmState, randoms: torch.Tensor, energy_fn):
        device = randoms.device
        self.recording = metrics.recording()
        self.state = SwarmState(*(f.clone() for f in state))
        self.randoms = randoms.clone()
        self.energy, self.move = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))

        def move():
            new, _ = gso.gso_move(params, self.state, self.scoring.to(self.state.t.dtype),
                                  self.randoms)
            for s, f in zip(self.state, new):
                if f is not s:
                    s.copy_(f)
            return new

        def both():
            self.scoring = _captured(self.energy, pool, stream,
                                     lambda: gso.gso_energy(params, self.state, energy_fn))
            return _captured(self.move, pool, stream, move)

        # The move's outputs stay referenced, as the replays write them.
        self._moved, self.counts = counted_once(both)
        torch.cuda.current_stream(device).wait_stream(stream)

    def run(self, state: SwarmState, randoms: torch.Tensor, outs: StepOutput,
            first: int) -> None:
        """Steps ``first`` to ``randoms.shape[0] - 1`` from ``state`` (copied
        into the static buffers), each step's state into its row of
        ``outs``.  A step's replays take the spans ``energy`` and ``move``
        of ``gso.gso_step``: the host time its launches cost.  While a
        recorder is active each step adds the capture's counters and one
        to ``graph_steps``."""
        for s, f in zip(self.state, state):
            s.copy_(f)
        recording = metrics.recording()
        for i in range(first, randoms.shape[0]):
            with metrics.span("energy"):
                self.energy.replay()
                self.counts.replayed()
            with metrics.span("move"):
                self.randoms.copy_(randoms[i])
                self.move.replay()
                for o, s in zip(outs, self.state):
                    o[i].copy_(s)
            if recording:
                metrics.count("graph_steps", 1)


class GsoTorchRunner:
    """Runs one swarm: precomputes the random stream, steps the swarm on
    ``device`` and writes snapshots in the reference's cadence and
    format.

    ``rng_mode`` 'reference' draws the bit-exact rand-0.7 stream on the
    host; 'native' draws :func:`native_stream` on the device.  Either is
    made from its start and sliced at the resumed step, so a resumed run
    takes the draws of the uninterrupted one.

    ``energy_dtype`` (None: ``dtype``) is the dtype the energy is built
    and scored at; the state, the moves, the snapshots and
    ``load_snapshot`` stay at ``dtype``, and ``self.params`` is at
    ``energy_dtype`` (the move reads only ``params.use_anm``).  The kernel
    modes take float32 only: on the card a float64 state needs
    ``energy_dtype=torch.float32`` there, and a float64 energy raises at
    the kernel's first call.

    On the card in a kernel mode the steps are replayed from CUDA graphs
    (:class:`StepGraphs`), captured once a runner.  Their memory pool stays
    reserved after the runner is dropped, until the cache is emptied or an
    allocation finds the card full: a process that builds runner after
    runner calls :meth:`release` on each it is done with."""

    def __init__(self, params: BatchScoringParams, positions, seed: int,
                 use_anm: bool, anm_rec: int, anm_lig: int,
                 output_directory: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 energy_mode: str = "kernel", energy_chunk: int = 0,
                 dq_bf16: bool = False, cull: bool = True,
                 rng_mode: str = "reference",
                 energy_dtype: Optional[torch.dtype] = None):
        device = cuda_device(device, "GsoTorchRunner")
        if rng_mode not in RNG_MODES:
            raise ValueError(f"rng_mode must be one of {RNG_MODES}, got {rng_mode!r}")
        self.energy_mode = resolve_energy_mode(params, energy_mode, device,
                                               positions.shape[0], "GsoTorchRunner",
                                               replayed=True)
        self.params, energy_fn = make_energy(
            params, self.energy_mode, device, energy_dtype or dtype, energy_chunk,
            dq_bf16, cull)
        self.energy_fn = mixed_precision_energy(energy_fn, dtype, energy_dtype)
        self.device = device
        self.state = init_state(positions, use_anm, anm_rec, anm_lig,
                                dtype=dtype, device=device)
        self._initial_state = self.state
        self.use_anm = use_anm
        self.output_directory = output_directory
        self._stream = (functools.partial(uniform_f64_stream, seed)
                        if rng_mode == "reference"
                        else functools.partial(native_stream, seed, device))
        self._start_step = 0  # completed steps
        self._replay = use_graphs(device, self.energy_mode)
        self._graphs = None  # StepGraphs, captured at the first replayed step

    def reset(self) -> None:
        """Rewind to the initial swarm state.  Timed repeats must restart
        the trajectory: a converged swarm moves fewer poses, and the
        rescoring gate would make it look faster."""
        self._start_step = 0
        self.state = self._initial_state

    def release(self) -> None:
        """Drop the step's graphs and hand their memory pool back to the
        card (``torch.cuda.empty_cache``).  A later replayed run captures
        them again."""
        if self._graphs is not None:
            self._graphs = None
            torch.cuda.empty_cache()

    def load_snapshot(self, path, step: Optional[int] = None) -> None:
        """Resume from a ``gso_N.out`` snapshot written at ``step``.

        Its ``.npz`` sidecar, where there is one, gives the state's bits:
        the resumed run is bit-identical to the uninterrupted one.  Else
        the text is parsed (7 and 8 decimals, as the reference writes it:
        a snapshot without a sidecar, for example the reference's), and
        ``step`` must be given.  The random stream resumes at step x G
        draws (one draw a glowworm a step, reference src/swarm.rs:118)."""
        sidecar = read_state_sidecar(path)
        if sidecar is not None:
            sc_step, arrays = sidecar
            self.state = SwarmState(**{
                k: torch.as_tensor(arrays[k], device=self.device)
                for k in SwarmState._fields})
            self._start_step = int(step) if step else sc_step
            return
        poses, luc, nn, vis, sco = read_gso_output(path)
        if step is None:
            raise ValueError(f"no sidecar next to {path}; pass the snapshot's step")
        t, q, ar, al = split_positions(poses, self.use_anm,
                                       self.state.a_rec.shape[1],
                                       self.state.a_lig.shape[1])
        dtype = self.state.t.dtype

        def tensor(x, dt=dtype):
            return torch.as_tensor(x, dtype=dt, device=self.device)

        self.state = SwarmState(
            t=tensor(t), q=tensor(q), a_rec=tensor(ar), a_lig=tensor(al),
            luciferin=tensor(luc), vision=tensor(vis), scoring=tensor(sco),
            num_neighbors=tensor(nn, torch.int32))
        self._start_step = int(step)

    def _randoms(self, steps: int) -> torch.Tensor:
        g = self.state.t.shape[0]
        r = self._stream(steps * g)[self._start_step * g:].reshape(-1, g)
        return torch.as_tensor(r, dtype=self.state.t.dtype, device=self.device)

    def run(self, steps: int):
        """Run to ``steps`` completed steps; returns (state, StepOutput)."""
        if steps <= self._start_step:
            return self.state, None
        start = self._start_step
        self.state, outs = self._steps(self._randoms(steps), True)
        if self.output_directory is not None:
            self._write_snapshots(outs, steps, start)
        self._start_step = steps
        return self.state, outs

    def run_segmented(self, steps: int, segment: int = 10, metrics=None):
        """Run to ``steps`` in segments of ``segment`` steps, writing each
        segment's snapshots as it ends: a crash loses at most a segment.
        ``metrics`` (``utils.metrics.RunMetrics``) gets each segment's
        poses and seconds, the device synchronized before the clock is
        read.  The random stream ends the command line's ``runner_setup``
        span."""
        g = self.state.t.shape[0]
        randoms = self._randoms(steps)
        end_span("runner_setup")
        base = self._start_step
        outs = None
        while self._start_step < steps:
            start = self._start_step
            target = min(start + segment, steps)
            t0 = time.perf_counter()
            self.state, outs = self._steps(randoms[start - base:target - base],
                                           start == base)
            if self.output_directory is not None:
                self._write_snapshots(outs, target, start)
            self._start_step = target
            if metrics is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                metrics.segment(start, target, (target - start) * g,
                                time.perf_counter() - t0)
        return self.state, outs

    def _steps(self, randoms: torch.Tensor, first_of_call: bool):
        """``randoms.shape[0]`` steps from ``self.state``: (state,
        StepOutput with each field stacked over steps), as ``run_swarm``
        gives them.  Where :func:`use_graphs`, the call's first step runs
        op by op and the rest are replayed from :class:`StepGraphs`,
        captured at the runner's first replayed step (again where a
        recorder has since been started or stopped)."""
        n = randoms.shape[0]
        if not self._replay or (first_of_call and n == 1):
            return run_swarm(self.params, self.state, randoms, self.energy_fn)
        state, first = self.state, int(first_of_call)
        if first:
            state, out = gso.gso_step(self.params, state, randoms[0], self.energy_fn)
        if self._graphs is None or self._graphs.recording != metrics.recording():
            self._graphs = StepGraphs(self.params, state, randoms[first], self.energy_fn)
        outs = StepOutput(*(torch.empty((n,) + tuple(f.shape), dtype=f.dtype,
                                        device=f.device) for f in state))
        if first:
            for o, f in zip(outs, out):
                o[0].copy_(f)
        self._graphs.run(state, randoms, outs, first)
        return SwarmState(*(o[-1] for o in outs)), outs

    def _poses_at(self, outs: StepOutput, i: int) -> np.ndarray:
        cols = [outs.t[i], outs.q[i]]
        if self.use_anm and outs.a_rec.shape[-1] > 0:
            cols.append(outs.a_rec[i])
        if self.use_anm and outs.a_lig.shape[-1] > 0:
            cols.append(outs.a_lig[i])
        return torch.cat(cols, dim=1).cpu().numpy().astype(np.float64)

    def _write_snapshots(self, outs: StepOutput, steps: int, start: int) -> None:
        outdir = pathlib.Path(self.output_directory)
        outdir.mkdir(parents=True, exist_ok=True)
        for step in range(start + 1, steps + 1):
            if step % 10 == 0 or step == 1:
                i = step - 1 - start
                path = outdir / f"gso_{step}.out"
                host = {k: getattr(outs, k)[i].cpu().numpy()
                        for k in SwarmState._fields}
                write_gso_output(path, self._poses_at(outs, i),
                                 host["luciferin"].astype(np.float64),
                                 host["num_neighbors"],
                                 host["vision"].astype(np.float64),
                                 host["scoring"].astype(np.float64))
                # The StepOutput after step i is the post-step state.
                write_state_sidecar(path, step, **host)
