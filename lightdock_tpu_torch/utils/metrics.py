"""Run metrics as JSON lines.

Copy of ``lightdock_tpu/utils/metrics.py``: one event a segment with its
timing and poses scored per second, and a summary; the command line writes
them with ``--metrics FILE``.  Events are also logged at DEBUG level to
``lightdock_tpu_torch.metrics``.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Optional

log = logging.getLogger("lightdock_tpu_torch.metrics")


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

    def segment(self, start_step: int, end_step: int, poses: int,
                seconds: float) -> None:
        self.total_poses += poses
        self.total_seconds += seconds
        self.emit("segment", start_step=start_step, end_step=end_step,
                  poses=poses, seconds=round(seconds, 4),
                  poses_per_s=round(poses / seconds, 1) if seconds > 0 else None)

    def summary(self) -> dict:
        s = {
            "total_poses_scored": self.total_poses,
            "total_seconds": round(self.total_seconds, 4),
            "poses_per_s": (round(self.total_poses / self.total_seconds, 1)
                            if self.total_seconds > 0 else None),
        }
        self.emit("summary", **s)
        return s

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
