"""Run metrics (counterpart of vidmat/utils/metrics.py)."""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np


def mad(a, b) -> float:
    """Mean absolute difference (the parity metric)."""
    return float(np.mean(np.abs(np.asarray(a, np.float64) -
                                np.asarray(b, np.float64))))


class RunMetrics:
    """Per-run metrics sink: fps, p50/p99 latency.

    Each observation is (seconds, frames covered): a chunked run records
    one observation per K-frame dispatch, and the percentiles are then
    per dispatch (summary() says so)."""

    def __init__(self) -> None:
        self.observations: list[tuple[float, int]] = []
        self._t0 = time.perf_counter()

    def record_frame(self, seconds: float) -> None:
        self.observations.append((seconds, 1))

    def record_chunk(self, seconds: float, k: int) -> None:
        self.observations.append((seconds, k))

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.observations:
            t = np.array([s for s, _ in self.observations])
            ks = [k for _, k in self.observations]
            out.update(
                frames=int(sum(ks)),
                fps=float(sum(ks) / t.sum()),
                p50_ms=float(np.percentile(t, 50) * 1e3),
                p99_ms=float(np.percentile(t, 99) * 1e3),
            )
            kset = set(ks)
            if kset != {1}:
                if len(kset) == 1:
                    out["latency_granularity"] = (
                        f"per-{ks[0]}-frame-dispatch")
                else:
                    out["latency_granularity"] = (
                        "mixed-granularity dispatch (k in "
                        f"{sorted(kset)}; percentiles are per-dispatch)")
        out["wall_s"] = time.perf_counter() - self._t0
        return out
