"""The device's side of a traced run: ``torch.profiler`` with CUDA activity
only (no host operator events, which would slow the host-bound program),
over whole jobs.

The profiler's clock is not the host's ``perf_counter_ns``, so a marker
kernel (``torch.cuda._sleep``, named ``spin_kernel``) is launched right
after a synchronize at the start and at the end: each marker's device
start, less the host time just before its launch, gives the offset that
places host spans on the device's time line.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np

MARKER = "spin_kernel"


class DeviceTrace(NamedTuple):
    events: list        # (name, start_ns, end_ns) of device kernels, copies and sets
    window: tuple       # (start_ns, end_ns) of the window on the host's clock
    offset: int         # device clock - host clock, ns
    busy: np.ndarray    # (n, 2) busy intervals on the host's clock: busy_intervals()


class Profiler:
    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.host = []

    def start(self):
        """Start tracing; returns the window's host start (ns)."""
        self.prof.__enter__()
        # One launch before the window, which the trace may or may not hold.
        self.torch.zeros(1, device=self.device).add_(1)
        return self._marker()

    def _marker(self):
        self.torch.cuda.synchronize(self.device)
        t = time.perf_counter_ns()
        self.torch.cuda._sleep(1000)
        self.torch.cuda.synchronize(self.device)
        self.host.append(t)
        return t

    def stop(self) -> DeviceTrace:
        end = self._marker()
        self.prof.__exit__(None, None, None)
        events, markers = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != self.torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns()
            item = (e.name(), start, start + e.duration_ns())
            (markers if MARKER in item[0] else events).append(item)
        events, offset = place(events, markers, self.host[0], end)
        return DeviceTrace(events, (self.host[0], end), offset,
                           busy_intervals(events, offset, self.host[0], end))


def place(events, markers, lo, hi):
    """(the device's events within the window [lo, hi] of the host's clock,
    the offset of the device's clock) from the marker kernels launched at
    ``lo`` and ``hi``.  The trace may lack one of the two (one traced run in
    fifteen did); the other still places it, at whichever end leaves the
    most events inside the window (the wrong end shifts them all by its
    length)."""
    if not markers:
        raise RuntimeError("the profiler's trace holds no marker kernel")
    starts = sorted(m[1] for m in markers)
    a = np.fromiter((e[1] for e in events), np.int64, len(events))

    def inside(offset):
        return int(((a - offset >= lo) & (a - offset <= hi)).sum())

    offset = max((m - h for m in (starts[0], starts[-1]) for h in (lo, hi)), key=inside)
    keep = (a - offset >= lo) & (a - offset <= hi)
    return [e for e, k in zip(events, keep) if k], offset


def busy_intervals(events, offset, lo, hi) -> np.ndarray:
    """(n, 2): the union of the intervals of ``events`` (on the device's
    clock, ``offset`` ahead of the host's) within [lo, hi] of the host's
    clock, sorted and disjoint; touching intervals merge."""
    a = np.fromiter((e[1] for e in events), np.int64, len(events)) - offset
    b = np.fromiter((e[2] for e in events), np.int64, len(events)) - offset
    a, b = np.maximum(a, lo), np.minimum(b, hi)
    keep = b > a
    a, b = a[keep], b[keep]
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    if not len(a):
        return np.empty((0, 2), np.int64)
    # An interval opens a new run where it starts after all before it end.
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:] > np.maximum.accumulate(b)[:-1]
    first = np.flatnonzero(new)
    return np.stack([a[first], np.maximum.reduceat(b, first)], axis=1)


def busy_ns(trace: DeviceTrace) -> int:
    return int((trace.busy[:, 1] - trace.busy[:, 0]).sum())


def idle_gaps(trace: DeviceTrace) -> np.ndarray:
    """(n, 2): the window's stretches with nothing on the device."""
    lo, hi = trace.window
    starts = np.concatenate([[lo], trace.busy[:, 1]])
    ends = np.concatenate([trace.busy[:, 0], [hi]])
    keep = ends > starts
    return np.stack([starts[keep], ends[keep]], axis=1)
