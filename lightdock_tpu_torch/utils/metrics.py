"""Run metrics as JSON lines, and the program's spans and counters.

``RunMetrics`` is a copy of ``lightdock_tpu/utils/metrics.py``: one event a
segment with its timing and poses scored per second, and a summary; the
command line writes them with ``--metrics FILE``.  Those events keep the
JAX package's keys and are also logged at DEBUG level to
``lightdock_tpu_torch.metrics``.

The recorder is the port's own.  While one is active (:func:`record`; the
command line activates one under ``--metrics``), :func:`span` records
``(name, start_ns, end_ns)`` on ``time.perf_counter_ns`` and :func:`count`
adds to a named counter: an int, or a tensor whose elements are summed,
which stays on the device with no operation of its own until the
segment's synchronize.  ``RunMetrics`` writes what was recorded since its
last such line as one ``trace`` event after each segment, and the rest
before the summary.  With no recorder active, :func:`span` returns one
shared no-op object and reads no clock; callers guard :func:`count` with
:func:`recording`, so that an untraced step neither builds its argument
nor calls it.  A recorder made with ``profile=True`` (``--profile``) also opens a
``torch.profiler.record_function`` range of each span's name; one made
with ``store=False`` does only that.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Optional

import torch

log = logging.getLogger("lightdock_tpu_torch.metrics")

_NOOP = contextlib.nullcontext()
_active = None  # the process's Recorder while record() is open


class Recorder:
    """Spans and counters since the last :meth:`take`."""

    def __init__(self, store: bool = True, profile: bool = False):
        self.store = store
        self.profile = profile
        self.spans = []      # (name, start_ns, end_ns)
        self.counters = {}   # name -> values added since the last take()
        self.open = {}       # name -> _Span opened by begin()

    def take(self):
        """(spans, {counter: int}) recorded since the last call, then
        cleared; the tensors counted are summed and read here (after the
        caller's synchronize)."""
        spans, counters = self.spans, self.counters
        self.spans, self.counters = [], {}
        return spans, {name: _total(values) for name, values in counters.items()}


def _total(values) -> int:
    """The sum of ints and of tensors' elements: one concatenation, one sum
    and one read for all the tensors of a segment."""
    tensors = [v.reshape(-1) for v in values if isinstance(v, torch.Tensor)]
    total = sum(int(v) for v in values if not isinstance(v, torch.Tensor))
    if tensors:
        total += int(torch.cat(tensors).sum())
    return int(total)


class _Span:
    __slots__ = ("rec", "name", "start", "range")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name, self.range = rec, name, None

    def __enter__(self):
        if self.rec.profile:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rec.store:
            self.rec.spans.append((self.name, self.start, end))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def recording() -> bool:
    """Whether a recorder that keeps spans and counters is active."""
    return _active is not None and _active.store


def span(name: str):
    """A context manager recording the block as a span ``name``; the shared
    no-op object when no recorder is active."""
    rec = _active
    if rec is None:
        return _NOOP
    return _Span(rec, name)


def begin(name: str) -> None:
    """Open a span ``name`` that :func:`end` closes, for a stretch that
    starts in one function and ends in another."""
    rec = _active
    if rec is not None:
        rec.open[name] = _Span(rec, name).__enter__()


def end(name: str) -> None:
    """Close the span ``name`` that :func:`begin` opened, if one is open."""
    rec = _active
    if rec is not None and name in rec.open:
        rec.open.pop(name).__exit__(None, None, None)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or the sum of a tensor's elements) to the
    counter ``name``.  A tensor is kept as it is, so it must not be
    written to afterwards, and summed at the next ``trace`` line: counting
    launches nothing on the device."""
    rec = _active
    if rec is not None and rec.store:
        rec.counters.setdefault(name, []).append(value)


@contextlib.contextmanager
def capture():
    """Keep what the block records apart from the active recorder: a fresh
    recorder takes its spans and counters (yielded, to be read by the
    caller), or none is active where none keeps any (yields None).  For
    code captured into a CUDA graph, whose Python runs once at capture:
    what it counts there is each replay's, not the capture's."""
    global _active
    outer = _active
    _active = Recorder() if outer is not None and outer.store else None
    try:
        yield _active
    finally:
        _active = outer


@contextlib.contextmanager
def record(store: bool = True, profile: bool = False):
    """Activate a recorder for the block (one a process: inside another
    block the active one is reused); yields it."""
    global _active
    if _active is not None:
        yield _active
        return
    _active = Recorder(store, profile)
    try:
        yield _active
    finally:
        _active = None


class RunMetrics:
    def __init__(self, path: Optional[str] = None, context: Optional[dict] = None):
        self.path = path
        self.context = context or {}
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()
        self.total_poses = 0
        self.total_seconds = 0.0

    def emit(self, event: str, **fields) -> None:
        record = {"event": event, "t": round(time.time() - self._t0, 4),
                  **self.context, **fields}
        line = json.dumps(record, sort_keys=True)
        log.debug("%s", line)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def trace(self) -> None:
        """Write what the active recorder holds as one ``trace`` line (not
        logged), and clear it; nothing when no recorder keeps any."""
        if not recording():
            return
        spans, counters = _active.take()
        if self._fh and (spans or counters):
            self._fh.write(json.dumps({"event": "trace", "spans": spans,
                                       "counters": counters}) + "\n")
            self._fh.flush()

    def segment(self, start_step: int, end_step: int, poses: int,
                seconds: float) -> None:
        self.total_poses += poses
        self.total_seconds += seconds
        self.emit("segment", start_step=start_step, end_step=end_step,
                  poses=poses, seconds=round(seconds, 4),
                  poses_per_s=round(poses / seconds, 1) if seconds > 0 else None)
        self.trace()

    def summary(self) -> dict:
        s = {
            "total_poses_scored": self.total_poses,
            "total_seconds": round(self.total_seconds, 4),
            "poses_per_s": (round(self.total_poses / self.total_seconds, 1)
                            if self.total_seconds > 0 else None),
        }
        self.trace()
        self.emit("summary", **s)
        return s

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
