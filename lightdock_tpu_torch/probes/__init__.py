"""The table-selection probes P1-P6 on the card: ports of ``scripts/exp_*.py``.

    python -m lightdock_tpu_torch.probes [--only P3] [--device cuda|cpu]

Each probe asks how DFIRE should pick a pair's table entry from its d2 (a
select chain, a tournament of selects, a count of the thresholds passed and
one indexed load, or the arithmetic slot ``trunc(2 sqrt(d2) - 1)`` and one
gather) and times the candidates as standalone kernels.  One module per
script, named after it, holds the script's shapes and thresholds,
``inputs()`` (the script's numpy draws, in its order, from its seeds) and
``variants(arrays)``, one :class:`Variant` per kernel the script times,
each calling a wrapper of :mod:`lightdock_tpu_torch.ops.probes` (the CUDA
kernels of ``csrc/probes.cu`` on the card, their plain versions on the
CPU).

The entry point runs on the card unless given ``--device cpu`` and raises
without one.  It prints one line a variant, ``name ms pairs/s chk=``, the
time from CUDA events over repeated calls after a warm-up (on the CPU from
the host clock), ``chk`` the output's sum as the scripts print it.  A
variant that fails raises: the entry point exits non-zero.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

from ..ops import probes as ops

SCRIPTS = {
    "P1": "exp_gather_kernel",
    "P2": "exp_gather2d",
    "P3": "exp_gather32",
    "P4": "exp_gather_forms",
    "P5": "exp_bisect",
    "P6": "exp_probe_ops",
}
TIMED_CALLS = 20   # kernel calls a timing on the card


@dataclasses.dataclass(frozen=True)
class Variant:
    """One kernel a probe times: the wrapper of :mod:`ops.probes` it calls
    (``op``), which arrays of the probe's inputs it passes as which
    arguments (``args``), its other arguments, its working type and the
    pair (or element) evaluations one call makes (``work``)."""

    name: str
    op: str
    args: dict
    kwargs: dict
    work: int
    dtype: torch.dtype = torch.float32

    def tensors(self, arrays, device):
        """This variant's inputs on ``device``: floats in its working type
        (converted on the host), integers as int32."""
        out = {}
        for name in self.args.values():
            a = np.asarray(arrays[name])
            t = torch.as_tensor(a)
            t = t.to(self.dtype) if a.dtype.kind == "f" else t.to(torch.int32)
            out[name] = t.to(device)
        return out

    def __call__(self, t):
        """The wrapper (kernel on the card, plain version on the CPU)."""
        return self.call(getattr(ops, self.op), t)

    def plain(self, t):
        """The plain version on any device."""
        return self.call(getattr(ops, self.op + "_plain"), t)

    def call(self, fn, t):
        return fn(**{k: t[v] for k, v in self.args.items()}, **self.kwargs)

    @property
    def counter(self):
        """The wrapper whose ``launches`` count this variant's kernel."""
        return getattr(ops, self.op)


def form_variant(name, form, args, reps=1, *, shape, **kwargs):
    """A :func:`ops.probes.gather_form` variant with (P, L) = ``shape``
    outputs; work is P L reps.  A probe module binds its ``shape`` once
    (``form = functools.partial(form_variant, shape=(P, L))``)."""
    return Variant(name, "gather_form", args, dict(form=form, reps=reps, **kwargs),
                   shape[0] * shape[1] * reps)


def load(probe: str):
    """The module of probe ``P1`` .. ``P6``."""
    return importlib.import_module(f"{__name__}.{SCRIPTS[probe]}")


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes run on the card unless "
                           "given --device cpu")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the probes run on cuda or cpu, not {dev.type}")
    return dev


def time_ms(fn, device, calls: int = TIMED_CALLS) -> float:
    """Milliseconds a call of ``fn`` after one warm-up: CUDA events over
    ``calls`` calls on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / calls


@dataclasses.dataclass
class Result:
    """One variant's run: its inputs on the device, output and ms a call."""

    probe: str
    variant: Variant
    inputs: dict
    out: torch.Tensor
    ms: float

    @property
    def pairs_per_s(self) -> float:
        return self.variant.work / (self.ms * 1e-3)

    @property
    def chk(self) -> float:
        return float(self.out.float().sum())

    def line(self) -> str:
        return (f"{self.probe}.{self.variant.name:24s} {self.ms:10.4f} ms  "
                f"{self.pairs_per_s:.4e} pairs/s  chk={self.chk:.4f}")


def run_variant(probe: str, variant: Variant, arrays, device, calls: int = TIMED_CALLS):
    """One variant through its wrapper on ``device``: its output and its
    time (:func:`time_ms`)."""
    t = variant.tensors(arrays, device)
    out = variant(t)
    ms = time_ms(lambda: variant(t), device, calls)
    return Result(probe, variant, t, out, ms)


def run(probes, device, calls: int = TIMED_CALLS, say=print):
    """Every variant of ``probes`` (ids P1 .. P6) on ``device``, printing
    one line each; returns the results."""
    results = []
    for probe in probes:
        mod = load(probe)
        arrays = mod.inputs()
        say(f"{probe} ({SCRIPTS[probe]}.py) on {device}")
        for v in mod.variants(arrays):
            res = run_variant(probe, v, arrays, device, calls)
            say(res.line())
            results.append(res)
    return results


def ab_line(results) -> str:
    """P3's A/B: pairs/s of the slot-and-gather loop against the chain."""
    by = {r.variant.name: r for r in results if r.probe == "P3"}
    g, c = by["v3gather"], by["v2chain"]
    return (f"P3 A/B: v3gather {g.pairs_per_s:.4e} pairs/s, v2chain "
            f"{c.pairs_per_s:.4e} pairs/s, gather/chain "
            f"{g.pairs_per_s / c.pairs_per_s:.4f}")
