"""The command line of the PyTorch port, argv-compatible with the
reference binary and with ``lightdock-tpu``:

    lightdock-tpu-torch <setup.json> <initial_positions_N.dat> <steps> <dfire|dna|pydock>
    python -m lightdock_tpu_torch.cli <setup.json> <initial_positions_N.dat> <steps> <method>

Port of ``lightdock_tpu/cli.py``.  Outputs go to ``./swarm_N/gso_{step}.out``
(created when missing); ANM ``.npy`` files are read from the working
directory.  A glob or a comma-separated list of positions files runs every
swarm in one farm (``parallel.farm.run_swarm_farm``); under torchrun the
farm's swarms split over the ranks, each on its own card, and each rank
writes its own swarms:

    torchrun --nproc-per-node N -m lightdock_tpu_torch.cli setup.json 'initial_positions_*.dat' 100 dfire

The run is on the CUDA card unless ``--platform cpu`` is given; without a
card it raises (``engine.runner.cuda_device``) and never carries on on the
CPU.  The flags are the JAX command line's, mapped so:

- ``--energy-mode``: ``auto`` (``engine.runner.pick_energy_mode``: on
  the card ``kernel`` for one swarm, whose steps are replayed from CUDA
  graphs, and for the glob ``kernel`` or ``dense`` by the method,
  receptor ANM and pair count, from a crossover map measured on an H100;
  ``dense`` on the CPU),
  ``kernel``, ``kernel_v1``, ``dense``; JAX's ``pallas`` and ``xla`` are
  taken as ``kernel`` and ``dense``.
- ``--energy-chunk``: the dense mode takes :func:`pick_energy_chunk`'s
  chunk by default; the kernel modes ignore it and score every pose in one
  call, as JAX's Pallas paths do.
- ``--dtype``: float32 on the card, float64 on the CPU by default;
  float64 on the card is refused but with ``--energy-mode dense`` (the
  kernels take float32 only).
- ``--r-tile``/``--l-tile``: refused (the card's kernel tiles are fixed).
- ``--jax-rng``: the runner's native stream (``engine.runner.
  native_stream``), deterministic but not JAX's.
- ``--profile``: ``torch.profiler`` over the run, a Chrome trace
  ``torch_trace.json`` in the output directory.  Each of the program's
  spans (below) is also a ``record_function`` range of the same name
  there.
- ``--metrics FILE``: JSON lines: one ``segment`` event a segment and a
  ``summary``, with the JAX command line's keys, and after each segment a
  ``trace`` event holding the program's spans since the last one, as
  ``[name, start_ns, end_ns]`` on ``time.perf_counter_ns``, and its
  counter (``utils.metrics``).  The spans: ``read_inputs`` (from the
  call's start to the runner's construction), ``runner_setup`` (to the
  first step), ``energy`` and ``move`` (each step), ``write_text`` and
  ``write_sidecar`` (each snapshot); the counter ``poses_scored``, the
  poses the energy calls were asked to score.  Without ``--metrics`` the
  program records nothing.
- ``--engine``: ``torch`` (the default; JAX's ``jax`` is taken as it)
  runs ``engine.runner.GsoTorchRunner``; ``host`` runs the float64 host
  parity engine (``engine.gso_host.GsoHostEngine``: the moves on the host
  in the reference's order, the energies on the card, or on the CPU with
  ``--platform cpu``).  The host engine refuses the flags it has no use
  for, where JAX's ignores them: a glob or list of positions files,
  ``--resume``, ``--metrics``, ``--profile``, ``--dq-bf16``,
  ``--energy-chunk`` (it scores 32 poses a call), ``--jax-rng``,
  ``--dtype float32``, a kernel ``--energy-mode`` and a
  ``--steps-per-save`` other than 10 (it saves at step 1 and every 10th).
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import logging
import os
import pathlib
import sys
import time

ENERGY_MODES = ("auto", "kernel", "kernel_v1", "dense")
ENERGY_MODE_ALIASES = {"pallas": "kernel", "xla": "dense"}
ENGINES = ("torch", "host")
ENGINE_ALIASES = {"jax": "torch"}


def _energy_mode(name: str) -> str:
    return ENERGY_MODE_ALIASES.get(name, name)


def _engine(name: str) -> str:
    return ENGINE_ALIASES.get(name, name)


def _is_multi(positions: str) -> bool:
    """A glob or a comma-separated list of positions files."""
    return "," in positions or any(c in positions for c in "*?[")


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lightdock-tpu-torch",
        description="GSO docking on a CUDA GPU (DFIRE / DNA / PYDOCK scoring)")
    ap.add_argument("setup", help="setup.json produced by lightdock3_setup.py")
    ap.add_argument("positions", help="initial_positions_N.dat, or a glob or "
                    "comma-separated list of them (one farm of swarms)")
    ap.add_argument("steps", type=int, help="number of GSO steps")
    ap.add_argument("method", type=str.lower, choices=["dfire", "dna", "pydock"])
    ap.add_argument("--engine", type=_engine, choices=ENGINES, default="torch",
                    help="torch: the batched engine (default; JAX's jax is "
                         "taken as it); host: the float64 host parity engine, "
                         "the moves on the host in the reference's order")
    ap.add_argument("--platform", choices=["auto", "cuda", "cpu"], default="auto",
                    help="auto and cuda run on the CUDA card (an error "
                         "without one); cpu runs the kernels' plain versions")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="compute precision (default: float32 on the card, "
                         "float64 on the CPU)")
    ap.add_argument("--energy-chunk", type=int, default=None,
                    help="poses of one dense energy call (default: from "
                         "the pair count; the kernel modes score all poses "
                         "in one call)")
    ap.add_argument("--anm-dir", default=None,
                    help="directory holding rec_nm.npy/lig_nm.npy "
                         "(default: working directory, like the reference)")
    ap.add_argument("--output-dir", default=None,
                    help="override output directory (default: ./swarm_N)")
    ap.add_argument("--steps-per-save", type=int, default=10)
    ap.add_argument("--energy-mode", type=_energy_mode, choices=ENERGY_MODES,
                    default="auto",
                    help="kernel: the v2 pair kernels; kernel_v1: the v1 "
                         "kernels; dense: the dense PyTorch energy; auto: "
                         "kernel or dense from the crossover map measured "
                         "on an H100 (dense on the CPU).  JAX's pallas and "
                         "xla are taken as kernel and dense")
    ap.add_argument("--dq-bf16", action="store_true",
                    help="store the DFIRE step tables in bfloat16 where the "
                         "mode reads them (kernel_v1, dense at float32)")
    ap.add_argument("--r-tile", type=int, default=None,
                    help="refused: the card's kernel tiles are fixed")
    ap.add_argument("--l-tile", type=int, default=None,
                    help="refused: the card's kernel tiles are fixed")
    ap.add_argument("--jax-rng", action="store_true",
                    help="draw a native torch stream on the device instead of "
                         "the bit-exact reference (rand 0.7) stream")
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of the run, the "
                         "program's spans as record_function ranges of the "
                         "same names")
    ap.add_argument("--metrics", metavar="FILE", default=None,
                    help="write JSON-lines run metrics to FILE: segment and "
                         "summary events, and trace events holding the "
                         "program's spans on time.perf_counter_ns and its "
                         "poses_scored counter")
    ap.add_argument("--resume", metavar="GSO_OUT",
                    help="resume from a previous gso_N.out snapshot; in "
                         "multi-swarm mode pass 'auto' to continue every "
                         "swarm from its newest sidecar checkpoint")
    ap.add_argument("--resume-step", type=int, default=0,
                    help="step number the snapshot corresponds to")
    return ap


def pick_energy_chunk(n_pairs: int, g: int, dtype_bytes: int) -> int:
    """Poses of one dense energy call: the (chunk, Nr, Nl) working set held
    to about 1.5 GB of intermediates, rounded to an even split of the
    glowworm axis; 0 when every pose fits."""
    budget = int(1.5e9 / (6 * dtype_bytes))  # ~6 live pair-sized arrays
    chunk = max(1, budget // max(n_pairs, 1))
    if chunk >= g:
        return 0  # no chunking needed
    n_seg = -(-g // chunk)
    return -(-g // n_seg)


@contextlib.contextmanager
def profiled(enabled: bool, device, out_dir, log):
    """``torch.profiler`` around the block when ``enabled`` (CUDA activity
    too on the card), its Chrome trace written to
    ``out_dir/torch_trace.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    trace = pathlib.Path(out_dir) / "torch_trace.json"
    prof.export_chrome_trace(str(trace))
    log.info("profiler trace written to %s", trace)


def host_refusals(args) -> list:
    """The flags of ``args`` that ``--engine host`` has no use for."""
    refused = [(_is_multi(args.positions), "a glob or list of positions files"),
               (args.resume is not None, "--resume"),
               (args.metrics is not None, "--metrics"),
               (args.profile, "--profile"),
               (args.dq_bf16, "--dq-bf16"),
               (args.energy_chunk is not None, "--energy-chunk"),
               (args.jax_rng, "--jax-rng"),
               (args.dtype == "float32", "--dtype float32"),
               (args.energy_mode in ("kernel", "kernel_v1"),
                f"--energy-mode {args.energy_mode}"),
               (args.steps_per_save != 10, "--steps-per-save")]
    return [flag for hit, flag in refused if hit]


def main(argv=None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    if args.r_tile is not None or args.l_tile is not None:
        parser.error("--r-tile/--l-tile are not taken: the card's kernel "
                     "tiles are fixed")
    refused = host_refusals(args) if args.engine == "host" else []
    if refused:
        parser.error(f"--engine host does not take {', '.join(refused)}: it runs "
                     "one swarm at float64 with the reference's stream, saving "
                     "at step 1 and every 10th step")
    device_name = "cpu" if args.platform == "cpu" else "cuda"
    dtype_name = args.dtype or ("float64" if device_name == "cpu" else "float32")
    if (args.engine == "torch" and device_name == "cuda" and dtype_name == "float64"
            and args.energy_mode != "dense"):
        parser.error(f"--dtype float64 on the card needs --energy-mode dense: "
                     f"the {args.energy_mode} mode's kernels take float32 only")
    logging.basicConfig(
        level=os.environ.get("LIGHTDOCK_TPU_LOG", "INFO"),
        format="%(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("lightdock_tpu_torch")

    from .utils.metrics import begin, record

    # --metrics keeps the program's spans and counter for its file;
    # --profile alone only names its ranges.
    tracing = (record(store=args.metrics is not None, profile=args.profile)
               if args.metrics or args.profile else contextlib.nullcontext())
    with tracing:
        begin("read_inputs")
        return run(args, log, device_name, dtype_name)


def run(args, log, device_name, dtype_name) -> int:
    """The command after its flags are checked: one swarm through
    :func:`run_torch` or :func:`run_host`, or the farm through
    :func:`run_multi`."""
    from .engine.runner import cuda_device
    from .simulation import load_simulation
    from .utils.positions import parse_swarm_id

    device = cuda_device(device_name, "lightdock-tpu-torch")

    # Multi-swarm mode: a glob or a comma-separated list of positions files
    # runs every swarm in one farm.
    multi = ([p for part in args.positions.split(",") for p in sorted(glob.glob(part))]
             if _is_multi(args.positions) else None)
    if multi:
        return run_multi(args, multi, log, device, dtype_name)

    print(f"Reading starting positions from {args.positions!r}")
    swarm_id = parse_swarm_id(args.positions)
    print(f"Swarm ID {swarm_id}")
    outdir = pathlib.Path(args.output_dir or f"swarm_{swarm_id}")
    if not outdir.is_dir():
        print(f"Output directory does not exist for swarm {swarm_id}, creating it",
              file=sys.stderr)
        outdir.mkdir(parents=True, exist_ok=True)
    print(f"Writing to swarm dir {str(outdir)!r}")

    print(f"Loading {args.method.upper()} scoring function")
    sim = load_simulation(args.setup, args.positions, args.method,
                          anm_dir=args.anm_dir)
    print(f"Creating GSO with {sim.positions.shape[0]} glowworms")

    start = time.time()
    if args.engine == "host":
        run_host(sim, args, outdir, device)
    else:
        run_torch(sim, args, outdir, log, device, dtype_name)
    print(f"Done ({args.steps} steps) in {time.time() - start:.2f}s")
    return 0


def run_multi(args, positions_files, log, device, dtype_name) -> int:
    """Every swarm in one farm (``parallel.farm``), its swarms split over
    the ranks of torchrun's world where there is one
    (``parallel.multihost.maybe_initialize_distributed``; ``--platform
    cpu`` takes the gloo backend).  Only rank 0 writes ``--metrics``,
    counting every rank's swarms in its segments (its ``trace`` lines hold
    rank 0's own spans and counter), and profiles with ``--profile``."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .parallel.multihost import maybe_initialize_distributed

    was_initialized = dist.is_initialized()
    maybe_initialize_distributed("gloo" if device.type == "cpu" else None)
    try:
        return _run_multi(args, positions_files, log, make_mesh(device=device),
                          dtype_name)
    finally:
        if dist.is_initialized() and not was_initialized:
            dist.destroy_process_group()


def _run_multi(args, positions_files, log, mesh, dtype_name) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from .parallel.farm import run_swarm_farm
    from .simulation import load_simulation
    from .utils.metrics import RunMetrics, begin, end
    from .utils.positions import parse_positions, parse_swarm_id

    device = mesh.device
    dtype = torch.float64 if dtype_name == "float64" else torch.float32
    sim = load_simulation(args.setup, positions_files[0], args.method,
                          anm_dir=args.anm_dir)
    swarm_ids = [parse_swarm_id(p) for p in positions_files]
    positions_list = [parse_positions(p) for p in positions_files]
    print(f"Running {len(positions_list)} swarms x "
          f"{positions_list[0].shape[0]} glowworms on {mesh.size} device(s) "
          f"[{device.type}]")
    if mesh.size > 1:
        block = mesh.swarm_block(len(positions_list))
        print(f"Rank {mesh.rank} of {mesh.size} ({dist.get_backend()}) on {device}: "
              f"{len(block)} swarms, ids {', '.join(str(swarm_ids[i]) for i in block)}")

    n_pairs = sim.receptor.num_atoms * sim.ligand.num_atoms
    g = positions_list[0].shape[0]
    chunk = (args.energy_chunk if args.energy_chunk is not None
             else pick_energy_chunk(n_pairs, g * len(positions_list),
                                    np.dtype(dtype_name).itemsize))
    end("read_inputs")
    begin("runner_setup")  # ended by SwarmFarmRunner.run_segmented's first step
    # Every rank keeps metrics (the farm waits for all at a segment's end);
    # rank 0 writes them.
    metrics = RunMetrics(args.metrics if mesh.rank == 0 else None, context={
        "backend": device.type, "dtype": dtype_name, "method": sim.method,
        "pairs": n_pairs, "glowworms": g, "swarms": len(positions_list)})
    output_root = args.output_dir or "."

    t0 = time.time()
    try:
        with profiled(args.profile and mesh.rank == 0, device, output_root, log):
            run_swarm_farm(sim.batch_params(dtype=np.dtype(dtype_name)),
                           positions_list, swarm_ids, sim.seed, args.steps,
                           sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                           dtype, output_root=output_root,
                           energy_chunk=chunk, energy_mode=args.energy_mode,
                           segment=max(1, args.steps_per_save),
                           metrics=metrics, resume=bool(args.resume), mesh=mesh)
        summary = metrics.summary()
    finally:
        metrics.close()
    dt = time.time() - t0
    total_poses = len(positions_list) * g * args.steps
    print(f"Done: {len(positions_list)} swarms x {args.steps} steps in "
          f"{dt:.2f}s ({total_poses / dt:.0f} poses/s aggregate)")
    if summary["poses_per_s"]:
        print(f"Throughput: {summary['poses_per_s']} poses/s")
    return 0


def run_host(sim, args, outdir, device) -> None:
    """One swarm through ``engine.gso_host.GsoHostEngine``."""
    from .engine.gso_host import GsoHostEngine

    engine = GsoHostEngine(sim.batch_params(), sim.positions, sim.seed,
                           sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                           output_directory=str(outdir), device=device)
    print(f"Starting optimization ({args.steps} steps)")
    engine.run(args.steps)


def run_torch(sim, args, outdir, log, device, dtype_name) -> None:
    """One swarm through ``engine.runner.GsoTorchRunner``."""
    import numpy as np
    import torch

    from .engine.runner import GsoTorchRunner
    from .utils.metrics import RunMetrics, begin, end

    dtype = torch.float64 if dtype_name == "float64" else torch.float32
    n_pairs = sim.receptor.num_atoms * sim.ligand.num_atoms
    g = sim.positions.shape[0]
    chunk = (args.energy_chunk if args.energy_chunk is not None
             else pick_energy_chunk(n_pairs, g, np.dtype(dtype_name).itemsize))
    log.info("backend=%s dtype=%s energy_chunk=%s pairs=%d",
             device.type, dtype_name, chunk, n_pairs)

    end("read_inputs")
    begin("runner_setup")  # ended by GsoTorchRunner.run_segmented's first step
    runner = GsoTorchRunner(
        sim.batch_params(dtype=np.dtype(dtype_name)), sim.positions, sim.seed,
        sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
        output_directory=str(outdir), dtype=dtype,
        device=device, energy_mode=args.energy_mode, energy_chunk=chunk,
        dq_bf16=args.dq_bf16,
        rng_mode="native" if args.jax_rng else "reference")
    if args.resume:
        runner.load_snapshot(args.resume, args.resume_step)
    print(f"Starting optimization ({args.steps} steps)")
    metrics = RunMetrics(args.metrics, context={
        "backend": device.type, "dtype": dtype_name, "method": sim.method,
        "pairs": n_pairs, "glowworms": g})
    try:
        with profiled(args.profile, device, outdir, log):
            runner.run_segmented(args.steps, max(1, args.steps_per_save), metrics=metrics)
        summary = metrics.summary()
    finally:
        metrics.close()
    if summary["poses_per_s"]:
        print(f"Throughput: {summary['poses_per_s']} poses/s")


if __name__ == "__main__":
    sys.exit(main())
