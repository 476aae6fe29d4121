"""Precision fidelity of the port: the float32 path against the float64
contract.

    python -m lightdock_tpu_torch.precision_fidelity --standin DIR [--hybrids]
    python -m lightdock_tpu_torch.precision_fidelity --device cpu --standin DIR

Port of ``scripts/precision_fidelity.py``.  The reference's hot loop is all
float64 and its goldens are float64 trajectories; the port's kernels run
float32.  On the 1azp DNA and the 1ppe DFIRE examples this measures what
that costs:

A. energy accuracy: per-pose |f32 - f64| / |f64| at the initial poses, for
   the float32 dense energy and the float32 kernel path (``kernel``, the v2
   kernels), against the float64 dense energy;
B. the trajectory horizon: the float32 run (``--engine``) against a float64
   run at the saved steps (1, 10, 20, ...): the first step whose rendered
   ``gso_N.out`` differs, and max |dscore| and max |dt| at each saved step
   (from the sidecars);
C. result equivalence at the last step: best score, top-10 overlap, Kendall
   tau of the whole rank order, BSAS cluster representatives.

``--hybrids`` adds a float64 run with seed + 1 (the optimizer's own spread)
and two hybrids, each against the float64 run: float32 state with a
float64 energy, and float64 state with a float32 energy
(``GsoTorchRunner(energy_dtype=...)``), both in the dense mode.

Where it departs from the script: one process runs every leg on
``--device`` (the card by default; ``cpu`` runs the kernels' plain
versions), the float64 legs too, in the dense mode; the modes take the
port's names (``xla`` is ``dense``, ``pallas`` is ``kernel``); rows are
keyed ``{example}_{device}_{mode}`` and a row of the card names it and its
power limit (``nvidia-smi``).  Inputs are
``$LIGHTDOCK_REFERENCE/example/{1azp,1ppe}`` (the float64 run of 1azp is
then held to the shipped goldens at steps 1 and 10, as the script holds
it), or, with ``--standin DIR``, stand-ins that ``standin.write_complex``
writes under DIR at the examples' shapes.  Results merge into ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import standin
from .cli import _energy_mode, pick_energy_chunk
from .engine.energy_dense import batch_pose_coords
from .engine.gso import init_state
from .engine.params import torch_params
from .engine.runner import GsoTorchRunner, cuda_device, make_energy
from .simulation import load_simulation
from .utils.clusters import cluster_bsas
from .utils.output import read_state_sidecar

EXAMPLES = {"1azp": "dna", "1ppe": "dfire"}
# Stand-ins at the examples' shapes: receptor atoms, ligand atoms,
# glowworms, ANM modes on each side.
STANDINS = {"1ppe": (1615, 221, 200, 0), "1azp": (1094, 506, 200, 10)}
DTYPES = {"f32": torch.float32, "f64": torch.float64, None: None}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def saved_steps(steps: int):
    """The steps a run of ``steps`` steps writes: 1, 10, 20, ..."""
    return [1] + list(range(10, steps + 1, 10))


def load_example(name, standin_dir=None):
    """(Simulation, method, from the reference) of example ``name``: the
    stand-in written under ``standin_dir`` where one is given, else
    ``$LIGHTDOCK_REFERENCE/example/name``."""
    method = EXAMPLES[name]
    if standin_dir is not None:
        ex = pathlib.Path(standin_dir) / name
        n_rec, n_lig, g, num_anm = STANDINS[name]
        standin.write_complex(ex, method, n_rec, n_lig, g, num_anm=num_anm)
    else:
        root = os.environ.get("LIGHTDOCK_REFERENCE")
        ex = pathlib.Path(root or ".") / "example" / name
        if not root or not ex.is_dir():
            raise SystemExit(f"no {ex}: set $LIGHTDOCK_REFERENCE to the "
                             "reference checkout, or pass --standin DIR")
    sim = load_simulation(ex / "setup.json", ex / "initial_positions_0.dat",
                          method, anm_dir=ex)
    return sim, method, standin_dir is None


def dense_chunk(sim, dtype: torch.dtype) -> int:
    """The dense mode's poses a call, as the command line picks them."""
    return pick_energy_chunk(sim.receptor.num_atoms * sim.ligand.num_atoms,
                             sim.positions.shape[0], dtype.itemsize)


def run_engine(sim, outdir, dtype_name, energy_mode, device, steps=100,
               energy_dtype=None, seed=None):
    """``steps`` GSO steps of ``GsoTorchRunner`` on ``device``, snapshots
    in ``outdir``; ``dtype_name`` and ``energy_dtype`` are 'f32' or 'f64'."""
    dtype, e_dtype = DTYPES[dtype_name], DTYPES[energy_dtype]
    chunk = dense_chunk(sim, e_dtype or dtype) if energy_mode == "dense" else 0
    runner = GsoTorchRunner(sim.batch_params(), sim.positions,
                            seed if seed is not None else sim.seed,
                            sim.use_anm, sim.setup.anm_rec, sim.setup.anm_lig,
                            output_directory=str(outdir), dtype=dtype,
                            device=device, energy_mode=energy_mode,
                            energy_chunk=chunk, energy_dtype=e_dtype)
    runner.run_segmented(steps, 10)


def kendall_tau(a, b):
    """Kendall rank correlation of two score vectors (O(n^2), n<=200)."""
    n = len(a)
    conc = disc = 0
    for i in range(n):
        da = a[i] - a[i + 1:]
        db = b[i] - b[i + 1:]
        s = np.sign(da) * np.sign(db)
        conc += int((s > 0).sum())
        disc += int((s < 0).sum())
    tot = n * (n - 1) // 2
    return (conc - disc) / tot if tot else 1.0


def pose_coords(sim, state):
    """Transformed ligand coordinates (G, Nl, 3) for cluster comparison,
    at float64 on the CPU."""
    p = torch_params(sim.batch_params(), "cpu", torch.float64)

    def f64(name):
        return torch.as_tensor(np.asarray(state[name], np.float64))

    _, lig = batch_pose_coords(p, f64("t"), f64("q"), f64("a_rec"), f64("a_lig"))
    return lig.numpy()


def initial_energies(sim, energy_mode, device, dtype):
    """(G,) float64 scores of the initial poses by ``energy_mode`` at
    ``dtype`` (``engine.runner.make_energy``, as a run's first step)."""
    chunk = dense_chunk(sim, dtype) if energy_mode == "dense" else 0
    params, energy_fn = make_energy(sim.batch_params(), energy_mode, device,
                                    dtype, chunk)
    st = init_state(sim.positions, sim.use_anm, sim.setup.anm_rec,
                    sim.setup.anm_lig, dtype=dtype, device=device)
    scores = energy_fn(params, st.t, st.q, st.a_rec, st.a_lig)
    return scores.to(torch.float64).cpu().numpy()


def f64_ref_energies(sim, device):
    """The float64 oracle energies at the initial poses (the dense mode)."""
    return initial_energies(sim, "dense", device, torch.float64)


def energy_accuracy(sim, ref, device):
    """Part A: per-pose initial-energy relative error of the float32 dense
    energy and the float32 kernel path against ``ref``."""
    def rel(e):
        denom = np.maximum(np.abs(ref), 1e-6)
        return np.abs(e - ref) / denom

    def stats(mode):
        r = rel(initial_energies(sim, mode, device, torch.float32))
        return {"max": float(r.max()), "median": float(np.median(r))}

    return {"dense_f32_rel_err": stats("dense"),
            "kernel_f32_rel_err": stats("kernel"),
            "kernel_plain": device.type == "cpu"}


def compare_runs(dir64, dir32, sim, steps=100):
    """Parts B and C from the two output directories."""
    horizon = []
    first_diff = None
    for step in saved_steps(steps):
        f64 = pathlib.Path(dir64) / f"gso_{step}.out"
        f32 = pathlib.Path(dir32) / f"gso_{step}.out"
        _, s64 = read_state_sidecar(f64)
        _, s32 = read_state_sidecar(f32)
        ds = np.abs(s64["scoring"] - s32["scoring"]).max()
        dt = np.abs(s64["t"] - s32["t"]).max()
        identical = f64.read_text() == f32.read_text()
        if not identical and first_diff is None:
            first_diff = step
        horizon.append({"step": step, "max_dscore": float(ds),
                        "max_dt": float(dt),
                        "rendered_identical": identical})

    _, e64 = read_state_sidecar(pathlib.Path(dir64) / f"gso_{steps}.out")
    _, e32 = read_state_sidecar(pathlib.Path(dir32) / f"gso_{steps}.out")
    sc64 = np.asarray(e64["scoring"], np.float64)
    sc32 = np.asarray(e32["scoring"], np.float64)
    top64 = set(np.argsort(-sc64)[:10].tolist())
    top32 = set(np.argsort(-sc32)[:10].tolist())

    cl64 = cluster_bsas(pose_coords(sim, e64), sc64)
    cl32 = cluster_bsas(pose_coords(sim, e32), sc32)
    reps64 = set(c.representative for c in cl64)
    reps32 = set(c.representative for c in cl32)

    return {
        "horizon": horizon,
        "first_rendered_divergence_step": first_diff,
        f"step{steps}": {
            "best_score_f64": float(sc64.max()),
            "best_score_f32": float(sc32.max()),
            "best_score_rel_diff": float(abs(sc64.max() - sc32.max())
                                         / max(abs(sc64.max()), 1e-9)),
            "best_pose_same": bool(np.argmax(sc64) == np.argmax(sc32)),
            "top10_overlap": len(top64 & top32),
            "kendall_tau": float(kendall_tau(sc64, sc32)),
            "n_clusters_f64": len(cl64),
            "n_clusters_f32": len(cl32),
            "cluster_rep_overlap": len(reps64 & reps32),
        },
    }


def card_line(device) -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[device.index or 0]


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m lightdock_tpu_torch.precision_fidelity",
        description="float32 against float64: energies, trajectory horizon, "
                    "result equivalence")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) runs every leg on the card, an "
                         "error without one; cpu runs the plain versions")
    ap.add_argument("--engine", type=_energy_mode, choices=["kernel", "dense"],
                    default="kernel",
                    help="the float32 leg's energy mode (JAX's pallas and "
                         "xla are taken as kernel and dense)")
    ap.add_argument("--examples", default="1azp,1ppe")
    ap.add_argument("--standin", metavar="DIR", default=None,
                    help="write stand-in inputs at the examples' shapes "
                         "under DIR and run those")
    ap.add_argument("--steps", type=int, default=100,
                    help="steps of every run, a multiple of 10")
    ap.add_argument("--out", default="PRECISION_torch.json")
    ap.add_argument("--hybrids", action="store_true",
                    help="also run the float64 seed + 1 control and the two "
                         "state/energy hybrids")
    return ap


def main(argv=None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    if args.steps < 10 or args.steps % 10:
        parser.error("--steps must be a positive multiple of 10")
    device = cuda_device(args.device, "precision_fidelity")
    card = card_line(device) if device.type == "cuda" else None
    on_card = {"card": card} if card else {}
    results = {}
    with tempfile.TemporaryDirectory(prefix="precision_") as work:
        work = pathlib.Path(work)
        for name in args.examples.split(","):
            sim, method, reference = load_example(name, args.standin)
            dir64 = work / f"{name}_f64"
            log(f"[{name}] f64 dense run ({device.type})")
            run_engine(sim, dir64, "f64", "dense", device, args.steps)
            if reference and name == "1azp":
                # The f64 leg must byte-match the shipped goldens.
                for step in (1, 10):
                    golden = (pathlib.Path(os.environ["LIGHTDOCK_REFERENCE"])
                              / "example/1azp/swarm_0" / f"gso_{step}.out")
                    if (dir64 / f"gso_{step}.out").read_text() != golden.read_text():
                        raise RuntimeError(f"f64 leg broke the {step} golden")
                log("[1azp] f64 leg byte-matches the shipped goldens (1, 10)")

            acc = energy_accuracy(sim, f64_ref_energies(sim, device), device)
            dir32 = work / f"{name}_f32"
            log(f"[{name}] f32 {args.engine} run ({device.type})")
            run_engine(sim, dir32, "f32", args.engine, device, args.steps)
            row = {"example": name, "method": method, "backend": device.type,
                   "engine_f32": args.engine, **on_card,
                   "energy_accuracy": acc}
            row.update(compare_runs(dir64, dir32, sim, args.steps))
            results[f"{name}_{device.type}_{args.engine}"] = row
            log(f"[{name}] first divergence step: "
                f"{row['first_rendered_divergence_step']}, step{args.steps}: "
                f"{json.dumps(row[f'step{args.steps}'])}")

            if args.hybrids:
                # The optimizer's own run-to-run spread: f32 against f64
                # inside it is as equivalent as another seed.
                dir_b = work / f"{name}_seedB"
                log(f"[{name}] f64 control run, seed+1 ({device.type})")
                run_engine(sim, dir_b, "f64", "dense", device, args.steps,
                           seed=sim.seed + 1)
                ctrl = compare_runs(dir64, dir_b, sim, args.steps)
                results[f"{name}_control_f64_seedB"] = {
                    "example": name, "note": "f64 seed=S vs f64 seed=S+1 - "
                    "the optimizer's own run-to-run spread", **ctrl}
                # Which precision term binds the f32 horizon: the state's
                # rounding alone, or the energy's alone.
                for label, sd, ed in (("f32_state_f64_energy", "f32", "f64"),
                                      ("f64_state_f32_energy", "f64", "f32")):
                    dh = work / f"{name}_{label}"
                    log(f"[{name}] hybrid {label} (dense, {device.type})")
                    run_engine(sim, dh, sd, "dense", device, args.steps,
                               energy_dtype=ed)
                    results[f"{name}_hybrid_{label}"] = {
                        "example": name, "state_dtype": sd, "energy_dtype": ed,
                        "engine": "dense", "backend": device.type, **on_card,
                        **compare_runs(dir64, dh, sim, args.steps)}

    out = pathlib.Path(args.out)
    merged = json.loads(out.read_text()) if out.exists() else {}
    merged.update(results)
    out.write_text(json.dumps(merged, indent=2) + "\n")
    log(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
