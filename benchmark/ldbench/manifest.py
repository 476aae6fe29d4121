"""The benchmark's data, found by name: ``workloads/<cell>.json``,
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.  A new cell, configuration, traffic mix or
metric is a new file and its entry in ``BENCHMARK.json``, which says
which cells report which metric; nothing here lists them.

A metric ``<base>.<tag>`` with no file of its own is the reader of
``<base>`` under another name, moving ``<base's MOVES>.<tag>``: cells whose
runs spread differently report their numbers under names of their own, so
that each name's bound follows its own cells' spread."""

from __future__ import annotations

import functools
import importlib.util
import json
import pathlib
import types

HERE = pathlib.Path(__file__).resolve().parents[1]
BENCHMARK = HERE.parent / "BENCHMARK.json"


def names(kind: str) -> list:
    """The names of every file of ``kind`` (``workloads``, ``configs``,
    ``traffic``, ``metrics``)."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (HERE / kind).glob(f"*{suffix}"))


def load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    return json.loads(path.read_text())


@functools.lru_cache(maxsize=None)
def metric(name: str):
    """The reader module ``metrics/<name>.py``, or that of its base (see
    the module's docstring)."""
    path = HERE / "metrics" / f"{name}.py"
    base, _, tag = name.rpartition(".")
    if not path.is_file() and base and (HERE / "metrics" / f"{base}.py").is_file():
        m = metric(base)
        out = types.SimpleNamespace(**{k: getattr(m, k) for k in dir(m)
                                       if k.isupper() or k == "read"})
        out.NAME = name
        if hasattr(m, "MOVES"):
            out.MOVES = f"{m.MOVES}.{tag}"
        return out
    if not path.is_file():
        raise FileNotFoundError(f"no metric named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"ldbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reported(name: str, benchmark: dict) -> tuple:
    """(end-to-end, per-layer) metric names that cell ``name`` reports: each
    metric of ``benchmark`` whose ``workloads`` lists the cell, or that has
    no such list."""
    def of(kind):
        return [m["name"] for m in benchmark[kind] if name in m.get("workloads", [name])]
    return of("end_to_end"), of("per_layer")


def cell(name: str) -> dict:
    """A cell with its configuration, traffic and metrics loaded in."""
    c = load("workloads", name)
    e2e, layer = reported(name, json.loads(BENCHMARK.read_text()))
    return dict(c, name=name, config=load("configs", c["config"]),
                traffic=load("traffic", c["traffic"]), end_to_end=e2e, per_layer=layer)
