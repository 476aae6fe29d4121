"""Analysis command line of the PyTorch port, the argv of
``lightdock-tpu-analysis`` (the native replacement for the reference's
shell-driven post-processing, reference example/1czy/analysis.sh):

    lightdock-tpu-torch-analysis rank    <root> <step> [--setup setup.json]
    lightdock-tpu-torch-analysis cluster <root> <step> --setup setup.json
    lightdock-tpu-torch-analysis top     <root> <step> --setup setup.json [-n 10]
    lightdock-tpu-torch-analysis all     <root> <step> --setup setup.json [-n 10]

Port of ``lightdock_tpu/cli_analysis.py``.  ``all`` clusters every swarm,
ranks the representatives and writes the top-N complexes into
<root>/top/.  The per-pose work (pose transforms, RMSD matrices, clash
counts) runs on the CUDA card unless ``--platform cpu`` is given; without
a card ``auto`` and ``cuda`` raise (``engine.runner.cuda_device``).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lightdock-tpu-torch-analysis")
    ap.add_argument("command", choices=["rank", "cluster", "top", "all"])
    ap.add_argument("root", help="simulation root containing swarm_*/")
    ap.add_argument("step", type=int)
    ap.add_argument("--setup", help="setup.json (needed for cluster/top)")
    ap.add_argument("-n", "--top-n", type=int, default=10)
    ap.add_argument("--rmsd-cutoff", type=float, default=4.0)
    ap.add_argument("--anm-dir", default=None)
    ap.add_argument("--reference-pdb", default=None,
                    help="reference ligand PDB (receptor frame, same atoms "
                         "as the docked ligand): fills the RMSD column")
    ap.add_argument("--clash-cutoff", type=float, default=1.9,
                    help="receptor-ligand distance (A) counted as a clash")
    ap.add_argument("--no-metrics", action="store_true",
                    help="skip RMSD/clash computation (fast rank)")
    ap.add_argument("--platform", choices=["auto", "cuda", "cpu"], default="auto",
                    help="auto and cuda compute on the CUDA card (an error "
                         "without one); cpu computes on the CPU")
    return ap


def _load_context(args):
    from .constants import DEFAULT_LIGHTDOCK_PREFIX
    from .simulation import load_anm
    from .utils.pdb import parse_pdb
    from .utils.setupfile import SetupFile

    if not args.setup:
        print("error: --setup is required for this command", file=sys.stderr)
        raise SystemExit(2)
    setup_path = pathlib.Path(args.setup)
    setup = SetupFile.from_file(setup_path)
    base = setup_path.parent
    rec_pdb = base / f"{DEFAULT_LIGHTDOCK_PREFIX}{setup.receptor_pdb}"
    lig_pdb = base / f"{DEFAULT_LIGHTDOCK_PREFIX}{setup.ligand_pdb}"
    lig = parse_pdb(lig_pdb)
    rec = parse_pdb(rec_pdb)
    _rec_nm, lig_nm = load_anm(setup, rec.num_atoms, lig.num_atoms,
                               anm_dir=args.anm_dir)
    nmodes = (np.asarray(lig_nm).reshape(setup.anm_lig, lig.num_atoms, 3)
              if setup.use_anm and setup.anm_lig > 0 and len(lig_nm)
              else np.zeros((0, lig.num_atoms, 3)))
    return setup, rec_pdb, lig_pdb, nmodes


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    from . import analysis
    from .engine.runner import cuda_device

    device = cuda_device("cpu" if args.platform == "cpu" else "cuda",
                         "lightdock-tpu-torch-analysis")
    root = pathlib.Path(args.root)

    if args.command == "rank" and (args.no_metrics or not args.setup):
        # Without structures: RMSD/Clashes stay -1.000 / 0, like the
        # reference pipeline run without a reference structure.
        ranked = analysis.rank_swarms(root, args.step)
        print(f"Ranked {len(ranked)} poses -> {root / 'rank_by_scoring.list'}")
        return 0

    setup, rec_pdb, lig_pdb, nmodes = _load_context(args)
    metrics = None
    if not args.no_metrics:
        metrics = analysis.make_pose_metrics(
            rec_pdb, lig_pdb, nmodes, setup.use_anm, setup.anm_rec,
            setup.anm_lig, reference_pdb=args.reference_pdb,
            clash_cutoff=args.clash_cutoff, device=device)

    if args.command == "rank":
        ranked = analysis.rank_swarms(root, args.step, pose_metrics=metrics)
        print(f"Ranked {len(ranked)} poses -> {root / 'rank_by_scoring.list'}")
        return 0

    if args.command in ("cluster", "all"):
        n_clusters = 0
        # String order of the directory names, as lightdock-tpu-analysis.
        for swarm_dir in sorted(root.glob("swarm_*")):
            clusters = analysis.cluster_swarm_dir(
                swarm_dir, lig_pdb, args.step, nmodes, setup.use_anm,
                setup.anm_rec, setup.anm_lig, cutoff=args.rmsd_cutoff, device=device)
            n_clusters += len(clusters)
        print(f"Clustered swarms under {root} ({n_clusters} clusters)")

    if args.command in ("top", "all"):
        ranked = analysis.rank_swarms(root, args.step, pose_metrics=metrics)
        paths = analysis.write_top(rec_pdb, lig_pdb, ranked, root / "top",
                                   nmodes, setup.use_anm, setup.anm_rec,
                                   setup.anm_lig, top_n=args.top_n, device=device)
        print(f"Wrote {len(paths)} top predictions -> {root / 'top'}")

    return 0


if __name__ == "__main__":
    sys.exit(main())
