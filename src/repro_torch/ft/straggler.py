"""Straggler detection + bounded-staleness sampling rounds.

RR sampling is stateless, so straggler mitigation is scheduling, not
recomputation: work is issued in fixed-size rounds; a StepTimer tracks
per-round wall time and flags shards whose round time exceeds
``threshold × median``.  In bounded-staleness mode the sampling loop stops
waiting for flagged shards after ``max_stale`` rounds — correctness is
unaffected because θ counts *arrived* RR sets (the martingale bound needs a
count, not a particular partition of who sampled what).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class StepTimer:
    window: int = 50
    times: list = field(default_factory=list)
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0

    def is_straggler(self, dt: float, threshold: float = 2.0) -> bool:
        return bool(self.times) and dt > threshold * self.median


@dataclass
class ShardMonitor:
    """Tracks per-shard round throughput; flags persistent stragglers."""
    n_shards: int
    threshold: float = 2.0
    rounds: dict = field(default_factory=dict)

    def report(self, shard: int, dt: float):
        self.rounds.setdefault(shard, []).append(dt)

    def stragglers(self) -> list[int]:
        meds = {s: np.median(v) for s, v in self.rounds.items() if v}
        if not meds:
            return []
        overall = np.median(list(meds.values()))
        return [s for s, m in meds.items() if m > self.threshold * overall]

    def work_weights(self) -> np.ndarray:
        """Inverse-latency weights for rebalancing round sizes."""
        w = np.ones(self.n_shards)
        for s, v in self.rounds.items():
            if v:
                w[s] = 1.0 / max(np.median(v), 1e-9)
        return w / w.sum()
