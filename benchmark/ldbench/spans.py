"""Host-clock spans around named callables of the program, from the
benchmark's side.

Each per-layer metric's file names the (module, attribute, label) triples
whose calls it reads; :class:`Spans` replaces each attribute by a wrapper
that records (label, start, end) in ``time.perf_counter_ns`` and calls the
original, and puts every original back on :meth:`Spans.close`.  An
attribute that is not there is reported, and the metrics that need it read
nothing.
"""

from __future__ import annotations

import functools
import importlib
import sys
import time


class Spans:
    def __init__(self, wraps):
        self.records = []          # (label, start_ns, end_ns)
        self.missing = set()       # "module:attribute" not found
        self._undo = []
        for module, attr, label in sorted(set(map(tuple, wraps))):
            self._wrap(module, attr, label)

    def _wrap(self, module, attr, label):
        try:
            owner = importlib.import_module(module)
            *path, name = attr.split(".")
            for part in path:
                owner = getattr(owner, part)
            original = getattr(owner, name)
        except (ImportError, AttributeError):
            self.missing.add(f"{module}:{attr}")
            print(f"spans: {module}:{attr} not found; metrics that read it "
                  "report nothing", file=sys.stderr)
            return
        records = self.records

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return original(*args, **kwargs)
            finally:
                records.append((label, t0, time.perf_counter_ns()))

        setattr(owner, name, wrapper)
        self._undo.append((owner, name, original))

    def mark(self, label, start_ns, end_ns):
        """A span the harness itself measured (a whole job, the window)."""
        self.records.append((label, start_ns, end_ns))

    def of(self, label, start_ns=None, end_ns=None):
        """The (start, end) spans of ``label`` that begin within [start, end)."""
        return [(a, b) for name, a, b in self.records if name == label
                and (start_ns is None or start_ns <= a < end_ns)]

    def close(self):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)
        self._undo.clear()
