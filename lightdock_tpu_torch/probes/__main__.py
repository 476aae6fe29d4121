"""``python -m lightdock_tpu_torch.probes [--only P3] [--device cuda|cpu]``:
run the table-selection probes (see the package docstring)."""

from __future__ import annotations

import argparse
import sys

from . import SCRIPTS, ab_line, resolve_device, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m lightdock_tpu_torch.probes",
                                     description=__doc__)
    parser.add_argument("--only", action="append", choices=sorted(SCRIPTS),
                        help="run only this probe (repeatable); default all six")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the kernels, the default) or cpu (their plain versions)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    results = run(args.only or sorted(SCRIPTS), device)
    if any(r.probe == "P3" for r in results):
        print(ab_line(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
