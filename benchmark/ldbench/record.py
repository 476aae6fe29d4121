"""What a run recorded, as the metric readers see it.

``jobs`` holds one dict a timed job: ``t0``/``t1`` (``perf_counter_ns``
around the ``cli.main`` call), ``ok``, ``poses`` (swarms x glowworms x
steps), ``steps`` and, in a traced run, ``segments``: the seconds of each
segment the job's ``--metrics`` file gives.  ``spans`` is the
:class:`ldbench.spans.Spans` of a traced run and ``trace`` its
:class:`ldbench.devtrace.DeviceTrace` (None where there is none).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RunRecord:
    jobs: list
    setup_s: float
    spans: Optional[object] = None
    trace: Optional[object] = None

    @property
    def done(self) -> list:
        return [j for j in self.jobs if j["ok"]]

    def window_s(self) -> float:
        """From the first job's start to the last job's end."""
        return (self.jobs[-1]["t1"] - self.jobs[0]["t0"]) * 1e-9

    def steps(self) -> int:
        return sum(j["steps"] for j in self.done)

    def span_s(self, label) -> float:
        """Seconds in spans of ``label`` within the timed jobs."""
        total = 0
        for j in self.done:
            total += sum(b - a for a, b in self.spans.of(label, j["t0"], j["t1"]))
        return total * 1e-9

    def span_count(self, label) -> int:
        return sum(len(self.spans.of(label, j["t0"], j["t1"])) for j in self.done)
