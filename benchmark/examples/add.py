#!/usr/bin/env python3
"""Add an example cell to a checkout, as new files and entries alone:

    python3 benchmark/examples/add.py benchmark/examples/<cell>.json <root>

Writes each of the example's ``files`` under ``<root>/benchmark/``, appends
its ``configs`` and ``workloads`` entries to ``<root>/BENCHMARK.json``,
and adds the cell to the ``workloads`` list of each metric the example
names.  The harness then finds the cell by name; no file it had changes.
What the checkout has already (a file, an entry of that name, the cell in
a metric's list) is left as it is, so adding to a checkout that holds the
cell, with its own files and limits, changes nothing.  :func:`strip` takes
the example's files and entries out again; :func:`copy_with` makes a copy
of the benchmark with the example added, for the tests.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]


def _entries(example) -> tuple:
    spec = json.loads(pathlib.Path(example).read_text())
    entries = spec["benchmark"]
    return spec["files"], entries, [w["name"] for w in entries["workloads"]]


def _metrics(bench, names):
    return [m for m in bench["end_to_end"] + bench["per_layer"]
            if m["name"] in names and "workloads" in m]


def add(example, root) -> list:
    """Add ``example`` (the path of an example's JSON) to the checkout at
    ``root``; returns the paths of the files written."""
    files, entries, cells = _entries(example)
    root = pathlib.Path(root)
    written = []
    for rel, content in files.items():
        path = root / "benchmark" / rel
        if not path.exists():
            path.write_text(json.dumps(content, indent=2) + "\n")
            written.append(path)
    bench_path = root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    for kind in ("configs", "workloads"):
        have = {e["name"] for e in bench[kind]}
        bench[kind] += [e for e in entries[kind] if e["name"] not in have]
    for metric in _metrics(bench, entries["metrics"]):
        metric["workloads"] += [c for c in cells if c not in metric["workloads"]]
    bench_path.write_text(json.dumps(bench, indent=2) + "\n")
    return written


def strip(example, root) -> None:
    """Take ``example``'s files and entries out of the checkout at ``root``,
    whatever their content there."""
    files, entries, cells = _entries(example)
    root = pathlib.Path(root)
    for rel in files:
        (root / "benchmark" / rel).unlink(missing_ok=True)
    bench_path = root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    for kind in ("configs", "workloads"):
        names = {e["name"] for e in entries[kind]}
        bench[kind] = [e for e in bench[kind] if e["name"] not in names]
    for metric in _metrics(bench, entries["metrics"]):
        metric["workloads"] = [c for c in metric["workloads"] if c not in cells]
    bench_path.write_text(json.dumps(bench, indent=2) + "\n")


def copy_of(target) -> pathlib.Path:
    """A copy of the benchmark, ``<target>/benchmark`` and
    ``<target>/BENCHMARK.json``; returns ``target``."""
    target = pathlib.Path(target)
    shutil.copytree(BENCH_DIR, target / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH_DIR.parent / "BENCHMARK.json", target / "BENCHMARK.json")
    return target


def copy_with(example, target) -> pathlib.Path:
    """A copy of the benchmark with ``example`` added; returns ``target``."""
    add(example, copy_of(target))
    return target


if __name__ == "__main__":
    for path in add(sys.argv[1], sys.argv[2]):
        print(path)
