"""The program's own spans and counters, as a traced run's jobs wrote them.

With ``--metrics FILE`` the program writes, after each segment, a line
``{"event": "trace", "spans": [[name, start_ns, end_ns], ...], "counters":
{...}}``: spans on ``time.perf_counter_ns``, the clock of the harness's
jobs and window and of :class:`ldbench.devtrace.DeviceTrace`'s busy
intervals, so they lie against the device's idle gaps as they are.  The
spans: ``read_inputs``, ``runner_setup`` (a job's host work before its
first step), ``energy`` and ``move`` (each GSO step), ``write_text`` and
``write_sidecar`` (each snapshot); the counter ``poses_scored``.

A job whose file holds no ``trace`` line (a program that records none)
gives nothing, and the readers then return None, never 0.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

SPANS = ("read_inputs", "runner_setup", "energy", "move", "write_text", "write_sidecar")


def job_trace(job):
    """(spans [(name, start_ns, end_ns)], {counter: total}) from the job's
    ``metrics.jsonl``, or None where it holds no trace line."""
    path = pathlib.Path(job["dir"]) / "metrics.jsonl"
    if not path.is_file():
        return None
    spans, counters, found = [], {}, False
    for line in path.read_text().splitlines():
        event = json.loads(line)
        if event.get("event") != "trace":
            continue
        found = True
        spans += [(name, int(a), int(b)) for name, a, b in event["spans"]]
        for name, value in event["counters"].items():
            counters[name] = counters.get(name, 0) + value
    return (spans, counters) if found else None


def traced(run) -> list:
    """[(job, spans, counters)] of the finished jobs that wrote trace lines."""
    out = []
    for job in run.done:
        found = job_trace(job)
        if found is not None:
            out.append((job, *found))
    return out


def spans_of(jobs, names) -> list:
    """The (start, end) of every span named in ``names`` over ``jobs``."""
    return [(a, b) for _, spans, _ in jobs for name, a, b in spans if name in names]


def total_ns(jobs, names) -> int:
    return sum(b - a for a, b in spans_of(jobs, names))


def union(intervals) -> np.ndarray:
    """(n, 2): the union of ``intervals`` (pairs), sorted and disjoint."""
    a = np.asarray(intervals, np.int64).reshape(-1, 2)
    if not len(a):
        return a
    a = a[np.argsort(a[:, 0], kind="stable")]
    new = np.ones(len(a), dtype=bool)
    new[1:] = a[1:, 0] > np.maximum.accumulate(a[:, 1])[:-1]
    first = np.flatnonzero(new)
    return np.stack([a[first, 0], np.maximum.reduceat(a[:, 1], first)], axis=1)


def measure(a: np.ndarray) -> int:
    return int((a[:, 1] - a[:, 0]).sum()) if len(a) else 0


def overlap_ns(a: np.ndarray, b: np.ndarray) -> int:
    """The length of the intersection of two sets of intervals, each (n, 2)
    and disjoint within itself: |a| + |b| - |a u b|."""
    return measure(a) + measure(b) - measure(union(np.concatenate([a, b]).reshape(-1, 2)))


def idle_in(run, names) -> int:
    """ns of the device's idle gaps (``ldbench.devtrace.idle_gaps``) inside
    spans named in ``names``, over the traced jobs; None without a device
    trace or such spans."""
    from ldbench.devtrace import idle_gaps

    spans = spans_of(traced(run), names)
    if run.trace is None or not spans:
        return None
    return overlap_ns(idle_gaps(run.trace), union(spans))


def idle_by_span(run) -> dict:
    """Seconds of the device's idle time by the program's span it falls in
    (``none``: in no span, the harness's gaps between jobs too), and
    ``idle`` and ``window`` in all; None without a device trace."""
    from ldbench.devtrace import idle_gaps

    if run.trace is None:
        return None
    gaps = idle_gaps(run.trace)
    jobs = traced(run)
    out = {name: overlap_ns(gaps, union(spans_of(jobs, {name}))) * 1e-9 for name in SPANS}
    idle = measure(gaps)
    out["none"] = (idle - overlap_ns(gaps, union(spans_of(jobs, set(SPANS))))) * 1e-9
    lo, hi = run.trace.window
    out["idle"], out["window"] = idle * 1e-9, (hi - lo) * 1e-9
    return out
