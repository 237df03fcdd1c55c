"""Latency SLO tracking.

Copy of ``blazr_tpu/server/slo.py`` (reference src/server/slo.rs): rolling
1000-sample windows for TTFT / ITL / e2e latency; p50/p95/p99 checked
against the configured LatencySlo; violations log a warning and bump the
violation counter.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Optional

import numpy as np

from ..config.server import LatencySlo

logger = logging.getLogger(__name__)

WINDOW = 1000


class RollingWindow:
    def __init__(self, maxlen: int = WINDOW):
        self._buf: deque[float] = deque(maxlen=maxlen)

    def record(self, value: float) -> None:
        self._buf.append(value)

    def percentile(self, p: float) -> Optional[float]:
        if not self._buf:
            return None
        return float(np.percentile(np.asarray(self._buf), p))

    def __len__(self) -> int:
        return len(self._buf)


class SloTracker:
    def __init__(self, slo: Optional[LatencySlo] = None, metrics=None):
        self.slo = slo or LatencySlo()
        self.metrics = metrics
        self.ttft = RollingWindow()
        self.itl = RollingWindow()
        self.e2e = RollingWindow()
        self.violations = 0

    def record_ttft(self, seconds: float) -> None:
        self.ttft.record(seconds * 1000.0)
        self._check("ttft", self.ttft,
                    [(50, self.slo.ttft_p50_ms), (95, self.slo.ttft_p95_ms),
                     (99, self.slo.ttft_p99_ms)])

    def record_itl(self, seconds: float) -> None:
        self.itl.record(seconds * 1000.0)
        self._check("itl", self.itl,
                    [(50, self.slo.itl_p50_ms), (95, self.slo.itl_p95_ms),
                     (99, self.slo.itl_p99_ms)])

    def record_e2e(self, seconds: float) -> None:
        self.e2e.record(seconds * 1000.0)
        self._check("e2e", self.e2e,
                    [(50, self.slo.e2e_p50_ms), (95, self.slo.e2e_p95_ms),
                     (99, self.slo.e2e_p99_ms)])

    def _check(self, name: str, window: RollingWindow,
               thresholds: list[tuple[int, Optional[float]]]) -> None:
        for p, limit in thresholds:
            if limit is None:
                continue
            v = window.percentile(p)
            if v is not None and v > limit:
                self.violations += 1
                logger.warning("SLO violation: %s p%d=%.1fms > %.1fms",
                               name, p, v, limit)
                if self.metrics is not None:
                    self.metrics.slo_violations.labels(metric=f"{name}_p{p}").inc()

    def snapshot(self) -> dict:
        out = {}
        for name, w in (("ttft", self.ttft), ("itl", self.itl), ("e2e", self.e2e)):
            out[name] = {f"p{p}": w.percentile(p) for p in (50, 95, 99)}
            out[name]["samples"] = len(w)
        out["violations"] = self.violations
        return out
