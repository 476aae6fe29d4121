"""Benchmark of the PyTorch port: poses scored a second on one GPU.

    python -m lightdock_tpu_torch.bench [--system 1ppe|1azp|1k4c] [--device cuda|cpu]
    python -m lightdock_tpu_torch.bench --crossover [--swarms S] [--points LABEL,...]

Port of the repository's ``bench.py``.  The default run times
``GsoTorchRunner`` for 100 GSO steps of one swarm of 200 glowworms on the
1ppe complex (1615 x 221 atoms, DFIRE, rigid): the real example where
``$LIGHTDOCK_REFERENCE/example/1ppe/setup.json`` exists, else the
1ppe-shaped stand-in ``standin.toy_system(1615, 221, 200)``.  One warm-up
run, then the min of 5 runs, each after ``reset()`` and ended by
``torch.cuda.synchronize()``.  The last line of standard output is one
JSON object with ``bench.py``'s keys (``metric``, ``value``, ``unit``,
``vs_baseline``) and ``device``, the card's name and power limit as
``nvidia-smi`` gives them ("cpu" with ``--device cpu``).  Diagnostics go to
standard error: the energy mode the runner resolved, each run's wall time,
pair interactions a second, the pair kernels' launches in the timed runs,
and the aggregate poses/s of a 32-swarm farm (``SwarmFarmRunner``, 50
steps, one warm-up; ``LIGHTDOCK_BENCH_MULTISWARM=0`` skips it).  A failure
anywhere, the farm included, exits non-zero.

``--system 1azp`` (``toy_system(1094, 506, 200, num_anm=10,
method="dna")``, 10 + 10 ANM modes) and ``--system 1k4c``
(``standin.membrane_system(200)``) time the other two reference examples'
stand-ins the same way, without the farm.

``--crossover`` times the ``kernel`` mode against ``dense`` on one swarm of
200 (``GsoTorchRunner``), or on a farm of ``--swarms`` S swarms of 200
(``SwarmFarmRunner``, S x 200 poses a call), for 50 steps (the fastest
of 7 runs of each, each after ``reset()``, after a 10-step warm-up; the
runs in 7 passes over all the points, the modes in turns) at stand-ins
of the reference examples' sizes, or at the points ``--points`` names,
the dense mode with ``cli.pick_energy_chunk``'s chunk; a point whose
dense runs would take more than 20 s together is timed over fewer steps,
and its line says so.  It prints a line a point and, last, one JSON
object with the table: the data behind ``engine.runner.pick_energy_mode``
(``engine.runner.CROSSOVER_MAP``).

``LIGHTDOCK_BENCH_MODE`` sets the energy mode (default ``auto``) and
``LIGHTDOCK_BENCH_TIMEOUT`` the seconds after which the run aborts (default
3000).  The run is on the CUDA card; without one it raises, and only
``--device cpu`` (for tests) runs the plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from . import standin
from .cli import pick_energy_chunk
from .engine.runner import (CROSSOVER_TIE, GsoTorchRunner, cuda_device,
                            pick_energy_mode)
from .ops import dfire_pairs, dfire_pairs_v1, elec_vdw_pairs, elec_vdw_pairs_v1
from .parallel.farm import SwarmFarmRunner
from .simulation import load_simulation

BASELINE_POSES_PER_S = 4700.0  # the reference's upper bound (BASELINE.md, 1ppe)
SEED = 324324
STEPS, SEGMENT, REPEATS = 100, 10, 5
GLOWWORMS = 200
ATOMS_1PPE = (1615, 221)
ATOMS_1AZP, ANM_1AZP = (1094, 506), 10
ATOMS_1K4C = standin.K4C_ATOMS
FARM_SWARMS, FARM_STEPS = 32, 50
METRICS = {"1ppe": "poses_scored_per_sec_per_chip_1ppe_dfire",
           "1azp": "poses_scored_per_sec_per_chip_1azp_dna_anm",
           "1k4c": "poses_scored_per_sec_per_chip_1k4c_dfire_membrane"}
# --crossover: (label, method, receptor atoms, ligand atoms, ANM modes a
# side); None atoms is the 1k4c membrane stand-in.  The sizes are the
# reference examples' (SURVEY.md): truncated 1ppe receptors, 1czy, 2uuy,
# 1azp, and 1ppe's receptor against a 650-atom ligand (1.05M pairs); the
# other sizes with and without ANM (1ppe's receptor cut to 200 and 700
# atoms with ANM, 1czy DNA rigid, 1azp's receptor against 221 atoms with
# ANM) bracket each threshold of ``engine.runner.pick_energy_mode``.
CROSSOVER_POINTS = [
    ("1ppe r200", "dfire", 200, 221, 0),
    ("1czy", "dfire", 1281, 53, 0),
    ("1ppe r340", "dfire", 340, 221, 0),
    ("1ppe r700", "dfire", 700, 221, 0),
    ("1ppe r1100", "dfire", 1100, 221, 0),
    ("1ppe", "dfire", 1615, 221, 0),
    ("1k4c", "dfire", None, None, 0),
    ("1ppe r200 anm", "dfire", 200, 221, 10),
    ("1czy anm", "dfire", 1281, 53, 10),
    ("1ppe r700 anm", "dfire", 700, 221, 10),
    ("1ppe anm", "dfire", 1615, 221, 10),
    ("2uuy anm", "dfire", 1615, 415, 10),
    ("1615x650 anm", "dfire", 1615, 650, 10),
    ("1czy dna", "dna", 1281, 53, 0),
    ("1azp", "dna", 1094, 506, 0),
    ("1czy dna anm", "dna", 1281, 53, 10),
    ("1azp l221 anm", "dna", 1094, 221, 10),
    ("1azp anm", "dna", 1094, 506, 10),
    ("1azp pydock anm", "pydock", 1094, 506, 10),
]
CROSSOVER_STEPS, CROSSOVER_REPEATS, CROSSOVER_WARMUP = 50, 7, 10
CROSSOVER_DENSE_BUDGET_S = 20.0  # a point's dense runs, together
PAIR_KERNELS = (dfire_pairs.dfire_pairs, dfire_pairs.dfire_pairs_worklist,
                elec_vdw_pairs.elec_vdw_pairs, dfire_pairs_v1.dfire_pairs_v1,
                elec_vdw_pairs_v1.elec_vdw_pairs_v1)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" off
    the card."""
    if device.type != "cuda":
        return "cpu"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[device.index or 0]


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_launches() -> None:
    for k in PAIR_KERNELS:
        k.launches = 0


def launches() -> dict:
    return {k.__name__: k.launches for k in PAIR_KERNELS}


def system(name: str):
    """(params, positions, ANM modes a side, where it came from) of a
    benchmark system."""
    if name == "1ppe":
        ref = os.environ.get("LIGHTDOCK_REFERENCE")
        ex = pathlib.Path(ref) / "example" / "1ppe" if ref else None
        if ex is not None and (ex / "setup.json").exists():
            sim = load_simulation(ex / "setup.json", ex / "initial_positions_0.dat",
                                  "dfire")
            return (sim.batch_params(dtype=np.float32), sim.positions, 0,
                    "real 1ppe")
        params, pos, _ = standin.toy_system(*ATOMS_1PPE, GLOWWORMS)
        return params, pos, 0, "1ppe-shaped stand-in"
    if name == "1azp":
        params, pos, k = standin.toy_system(*ATOMS_1AZP, GLOWWORMS, num_anm=ANM_1AZP,
                                            method="dna")
        return params, pos, k, "1azp-shaped DNA + ANM stand-in"
    if name == "1k4c":
        params, pos = standin.membrane_system(GLOWWORMS, *ATOMS_1K4C)
        return params, pos, 0, "1k4c-shaped DFIRE membrane stand-in"
    raise ValueError(f"unknown system {name!r}")


def make_runner(params, positions, num_anm, mode, device, energy_chunk=0):
    return GsoTorchRunner(params, positions, seed=SEED, use_anm=num_anm > 0,
                          anm_rec=num_anm, anm_lig=num_anm, dtype=torch.float32,
                          energy_chunk=energy_chunk, energy_mode=mode, device=device)


def timed_runs(runner, steps, repeats, device):
    """Wall seconds of ``repeats`` runs of ``steps`` steps, each after
    ``reset()`` and ended by a synchronize."""
    times = []
    for _ in range(repeats):
        runner.reset()
        t0 = time.perf_counter()
        runner.run_segmented(steps, SEGMENT)
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return times


def bench_system(name: str, device, mode: str) -> dict:
    """The timed runs of one system; returns the result line's object."""
    params, positions, num_anm, origin = system(name)
    g = positions.shape[0]
    n_pairs = params.rec_coords.shape[0] * params.lig_coords.shape[0]
    log(f"workload: {origin} ({params.rec_coords.shape[0]}x{params.lig_coords.shape[0]} "
        f"atoms, {params.method}, {num_anm} + {num_anm} ANM modes, {g} glowworms)")
    runner = make_runner(params, positions, num_anm, mode, device)
    log(f"energy mode: {runner.energy_mode} (requested {mode})")

    t0 = time.perf_counter()
    runner.reset()
    runner.run_segmented(STEPS, SEGMENT)
    synchronize(device)
    log(f"first run: {time.perf_counter() - t0:.2f}s")
    reset_launches()
    times = timed_runs(runner, STEPS, REPEATS, device)
    log(f"kernel launches in the timed runs: {json.dumps(launches())}")
    best = min(times)
    poses_per_s = g * STEPS / best
    log(f"{STEPS}-step wall-clock: {best:.4f}s (runs: {['%.4f' % t for t in times]})")
    log(f"pair-interactions/s: {g * STEPS * n_pairs / best:.3e}")

    if name == "1ppe" and os.environ.get("LIGHTDOCK_BENCH_MULTISWARM", "1") != "0":
        aggregate_multiswarm(params, positions, device, mode)
    return {"metric": METRICS[name], "value": round(poses_per_s, 1), "unit": "poses/s",
            "vs_baseline": round(poses_per_s / BASELINE_POSES_PER_S, 2),
            "device": card_line(device)}


def aggregate_multiswarm(params, positions, device, mode) -> None:
    """Aggregate poses/s of ``FARM_SWARMS`` swarms in one farm on the
    device (``SwarmFarmRunner``): one warm-up, then ``reset()`` and one
    timed run of ``FARM_STEPS`` steps."""
    s, g = FARM_SWARMS, positions.shape[0]
    runner = SwarmFarmRunner(params, [positions] * s, list(range(s)), seed=SEED,
                             use_anm=False, anm_rec=0, anm_lig=0, dtype=torch.float32,
                             output_root=None, energy_mode=mode, device=device)
    log(f"multi-swarm energy mode: {runner.energy_mode} (requested {mode})")
    runner.run_segmented(FARM_STEPS, segment=FARM_STEPS)
    synchronize(device)
    runner.reset()
    reset_launches()
    t0 = time.perf_counter()
    runner.run_segmented(FARM_STEPS, segment=FARM_STEPS)
    synchronize(device)
    dt = time.perf_counter() - t0
    log(f"multi-swarm kernel launches in the timed run: {json.dumps(launches())}")
    agg = s * g * FARM_STEPS / dt
    log(f"multi-swarm aggregate: {s} swarms x {FARM_STEPS} steps on 1 device: "
        f"{agg:.0f} poses/s total ({agg / s:.0f} per swarm)")


def crossover_system(method, n_rec, n_lig, num_anm):
    if n_rec is None:
        params, pos = standin.membrane_system(GLOWWORMS, *ATOMS_1K4C)
        return params, pos
    params, pos, _ = standin.toy_system(n_rec, n_lig, GLOWWORMS, num_anm=num_anm,
                                        method=method)
    return params, pos


def crossover_runner(params, pos, num_anm, mode, device, swarms, chunk=0):
    """One swarm's ``GsoTorchRunner``, or a farm of ``swarms`` copies of
    the swarm."""
    if swarms == 1:
        return make_runner(params, pos, num_anm, mode, device, chunk)
    return SwarmFarmRunner(params, [pos] * swarms, list(range(swarms)), seed=SEED,
                           use_anm=num_anm > 0, anm_rec=num_anm, anm_lig=num_anm,
                           dtype=torch.float32, output_root=None, energy_mode=mode,
                           energy_chunk=chunk, device=device)


def crossover_setup(point, device, swarms) -> dict:
    """One point's runners, each warmed up, and the steps of its timed
    runs: ``CROSSOVER_STEPS``, or fewer where the dense runs would pass
    ``CROSSOVER_DENSE_BUDGET_S`` together."""
    label, method, n_rec, n_lig, num_anm = point
    params, pos = crossover_system(method, n_rec, n_lig, num_anm)
    n_pairs = params.rec_coords.shape[0] * params.lig_coords.shape[0]
    poses = swarms * pos.shape[0]
    chunk = pick_energy_chunk(n_pairs, poses, 4)
    runners = {"kernel": crossover_runner(params, pos, num_anm, "kernel", device, swarms),
               "dense": crossover_runner(params, pos, num_anm, "dense", device, swarms,
                                         chunk)}
    warm = {mode: timed_runs(r, CROSSOVER_WARMUP, 1, device)[0]
            for mode, r in runners.items()}
    steps = CROSSOVER_STEPS
    dense_s = warm["dense"] * CROSSOVER_STEPS / CROSSOVER_WARMUP * CROSSOVER_REPEATS
    if dense_s > CROSSOVER_DENSE_BUDGET_S:
        steps = max(1, int(CROSSOVER_STEPS * CROSSOVER_DENSE_BUDGET_S / dense_s))
    return {"point": label, "method": method, "rec_atoms": params.rec_coords.shape[0],
            "lig_atoms": params.lig_coords.shape[0], "pairs": n_pairs,
            "rec_anm": num_anm > 0, "anm_modes": num_anm, "swarms": swarms,
            "poses": poses, "steps": steps, "dense_chunk": chunk,
            "pick": pick_energy_mode(params, device, poses, replayed=swarms == 1),
            "runners": runners,
            "times": {mode: [] for mode in runners}}


def crossover_row(point) -> dict:
    """A point's row: poses/s of each mode (its fastest run), the winner
    and its lead, what the rule's pick lost by, each mode's spread."""
    times = point["times"]
    poses_s = {mode: point["poses"] * point["steps"] / min(t)
               for mode, t in times.items()}
    winner = max(poses_s, key=poses_s.get)
    loser = "dense" if winner == "kernel" else "kernel"
    row = {k: v for k, v in point.items() if k not in ("runners", "times")}
    return {**row, "kernel_poses_s": poses_s["kernel"], "dense_poses_s": poses_s["dense"],
            "kernel_spread": max(times["kernel"]) / min(times["kernel"]),
            "dense_spread": max(times["dense"]) / min(times["dense"]),
            "winner": winner, "lead": poses_s[winner] / poses_s[loser],
            "pick_lost_by": poses_s[winner] / poses_s[point["pick"]]}


def crossover(device, swarms=1, labels=None) -> dict:
    """``kernel`` against ``dense`` at every point.  The timed runs go in
    ``CROSSOVER_REPEATS`` passes over all the points, the modes in turns:
    one swarm's kernel path is bound by the host, whose speed drifts over
    seconds to minutes, so each mode's fastest run comes from samples
    spread over the whole measurement and not from one window of it."""
    t0 = time.perf_counter()
    chosen = [p for p in CROSSOVER_POINTS if labels is None or p[0] in labels]
    unknown = set(labels or ()) - {p[0] for p in chosen}
    if unknown:
        raise ValueError(f"no crossover points {sorted(unknown)}")
    points = [crossover_setup(point, device, swarms) for point in chosen]
    for i in range(CROSSOVER_REPEATS):
        for point in points:
            for mode in ("kernel", "dense") if i % 2 == 0 else ("dense", "kernel"):
                point["times"][mode] += timed_runs(point["runners"][mode], point["steps"],
                                                   1, device)
    rows = [crossover_row(point) for point in points]
    for row in rows:
        note = ("" if row["steps"] == CROSSOVER_STEPS else
                f" (timed over {row['steps']} steps: dense runs of "
                f"{CROSSOVER_STEPS} would take more than {CROSSOVER_DENSE_BUDGET_S:.0f} s)")
        print(f"crossover {row['point']}: {row['method']} {row['rec_atoms']}x"
              f"{row['lig_atoms']} = {row['pairs']} pairs, receptor ANM "
              f"{row['rec_anm']}, {row['poses']} poses a call: kernel "
              f"{row['kernel_poses_s']:.1f} poses/s, dense {row['dense_poses_s']:.1f} "
              f"(chunk {row['dense_chunk']}); runs spread "
              f"{row['kernel_spread']:.2f}x, {row['dense_spread']:.2f}x; "
              f"{row['winner']} by {row['lead']:.3f}x; pick {row['pick']}{note}",
              flush=True)
    print(f"crossover: {len(rows)} points, {CROSSOVER_REPEATS} passes in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"crossover": rows, "swarms": swarms, "steps": CROSSOVER_STEPS,
            "repeats": CROSSOVER_REPEATS, "tie": CROSSOVER_TIE,
            "device": card_line(device)}


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lightdock_tpu_torch.bench",
        description="poses scored a second by the PyTorch port on one GPU")
    ap.add_argument("--system", choices=list(METRICS), default="1ppe",
                    help="1ppe DFIRE (default, with the 32-swarm farm on "
                         "stderr), 1azp DNA + ANM or 1k4c DFIRE membrane")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; an error without a card) or cpu "
                         "(the kernels' plain versions, for tests)")
    ap.add_argument("--crossover", action="store_true",
                    help="time the kernel mode against dense at the "
                         "reference examples' sizes")
    ap.add_argument("--swarms", type=int, default=1,
                    help="--crossover on a farm of this many swarms of 200 "
                         "(default 1: one GsoTorchRunner)")
    ap.add_argument("--points", type=lambda v: v.split(","), default=None,
                    help="--crossover at these points only (labels, comma "
                         "separated)")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    def _deadline(_sig, _frm):
        log("bench deadline exceeded; aborting")
        os._exit(2)

    handler = signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(int(os.environ.get("LIGHTDOCK_BENCH_TIMEOUT", "3000")))
    try:
        device = cuda_device(args.device, "lightdock_tpu_torch.bench")
        log(f"torch {torch.__version__}, device {card_line(device)}")
        if args.crossover:
            result = crossover(device, args.swarms, args.points)
        else:
            result = bench_system(args.system, device,
                                  os.environ.get("LIGHTDOCK_BENCH_MODE", "auto"))
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, handler)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
