"""Setup-stage tools of the PyTorch port, the argv of ``lightdock-tpu-tools``:

    lightdock-tpu-torch-tools setup receptor.pdb ligand.pdb [-s 10] [-g 200] [--anm] [--noh]
    lightdock-tpu-torch-tools flatten lightdock_rec.nm.npy rec_nm.npy

Port of ``lightdock_tpu/cli_tools.py``.  ``setup`` writes a run's inputs
(``setup_sim.run_setup``: the ``lightdock_*.pdb`` working copies,
``init/initial_positions_N.dat``, ``setup.json``); ``flatten`` turns a
(n_modes, n_atoms, 3) ANM tensor into the flat 1-D layout the command line
reads (the external lgd_flatten.py step, reference
example/1czy/execution.sh:10-12).  Both are host work.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="lightdock-tpu-torch-tools")
    sub = ap.add_subparsers(dest="command", required=True)
    fl = sub.add_parser("flatten", help="flatten an ANM .npy to 1-D")
    fl.add_argument("src")
    fl.add_argument("dst")
    st = sub.add_parser("setup", help="generate swarms/positions/setup.json "
                                      "(native lightdock3_setup.py equivalent)")
    st.add_argument("receptor_pdb")
    st.add_argument("ligand_pdb")
    st.add_argument("-s", "--swarms", type=int, default=10)
    st.add_argument("-g", "--glowworms", type=int, default=200)
    st.add_argument("--anm", action="store_true", help="enable ANM DoF")
    st.add_argument("--anm-rec", type=int, default=10)
    st.add_argument("--anm-lig", type=int, default=10)
    st.add_argument("--seed", type=int, default=None)
    st.add_argument("--starting-points-seed", type=int, default=None)
    st.add_argument("--noh", action="store_true", help="strip hydrogens")
    st.add_argument("--workdir", default=".")
    return ap


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.command == "flatten":
        data = np.load(args.src)
        np.save(args.dst, np.ascontiguousarray(data, dtype=np.float64).reshape(-1))
        print(f"{args.src} {data.shape} -> {args.dst} ({data.size},)")
    elif args.command == "setup":
        from .constants import DEFAULT_SEED
        from .setup_sim import SetupConfig, run_setup
        cfg = SetupConfig(
            receptor_pdb=args.receptor_pdb,
            ligand_pdb=args.ligand_pdb,
            swarms=args.swarms,
            glowworms=args.glowworms,
            use_anm=args.anm,
            anm_rec=args.anm_rec,
            anm_lig=args.anm_lig,
            seed=args.seed if args.seed is not None else DEFAULT_SEED,
            starting_points_seed=(args.starting_points_seed
                                  if args.starting_points_seed is not None
                                  else DEFAULT_SEED),
            noh=args.noh,
        )
        run_setup(cfg, args.workdir)
        print(f"Setup complete: {args.swarms} swarms x {args.glowworms} "
              f"glowworms under {args.workdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
