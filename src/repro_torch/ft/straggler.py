"""Straggler detection & mitigation policy.

Tracks per-rank step durations in a sliding window; a rank whose median
exceeds ``threshold ×`` the fleet median is flagged. Mitigation advice is
graded: first 'rebalance' (shrink that rank's microbatch share), then
'evict' (treat as failed → elastic re-mesh) when persistently slow —
the policy the launcher consumes. Pure Python: the port of
``repro.ft.straggler``, unchanged.
"""

from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass
from typing import Deque, Dict, List

__all__ = ["StragglerMonitor", "Advice"]


@dataclass(frozen=True)
class Advice:
    rank: int
    action: str  # "rebalance" | "evict"
    slowdown: float


class StragglerMonitor:
    def __init__(self, ranks: List[int], window: int = 16, threshold: float = 1.5, evict_after: int = 3):
        self.window = window
        self.threshold = threshold
        self.evict_after = evict_after
        self._hist: Dict[int, Deque[float]] = {r: collections.deque(maxlen=window) for r in ranks}
        self._strikes: Dict[int, int] = {r: 0 for r in ranks}

    def add_rank(self, rank: int) -> None:
        """Start tracking ``rank`` (elastic remesh path: survivors mapped
        to new coordinates, or capacity added back). Without this, a rank
        introduced after construction accumulated no history and could
        never be flagged — ``record_step`` silently dropped it. Idempotent;
        re-adding an existing rank keeps its history."""
        if rank not in self._hist:
            self._hist[rank] = collections.deque(maxlen=self.window)
            self._strikes[rank] = 0

    def drop_rank(self, rank: int) -> None:
        """Stop tracking ``rank`` (evicted or dead): its history must not
        skew the fleet median the survivors are judged against."""
        self._hist.pop(rank, None)
        self._strikes.pop(rank, None)

    def record_step(self, durations: Dict[int, float]) -> None:
        for r, d in durations.items():
            if r in self._hist:
                self._hist[r].append(d)

    def medians(self) -> Dict[int, float]:
        return {r: statistics.median(h) for r, h in self._hist.items() if h}

    def check(self) -> List[Advice]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        fleet = statistics.median(meds.values())
        out: List[Advice] = []
        for r, m in meds.items():
            slow = m / fleet if fleet > 0 else 1.0
            if slow > self.threshold:
                self._strikes[r] += 1
                action = "evict" if self._strikes[r] >= self.evict_after else "rebalance"
                out.append(Advice(r, action, slow))
            else:
                self._strikes[r] = 0
        return out

    def rebalance_shares(self, total_microbatches: int) -> Dict[int, int]:
        """Inverse-speed microbatch shares (straggler mitigation)."""
        meds = self.medians()
        if not meds:
            return {}
        inv = {r: 1.0 / m for r, m in meds.items()}
        z = sum(inv.values())
        shares = {r: max(1, round(total_microbatches * v / z)) for r, v in inv.items()}
        # fix rounding drift
        drift = total_microbatches - sum(shares.values())
        for r in sorted(shares, key=lambda r: -inv[r]):
            if drift == 0:
                break
            shares[r] += 1 if drift > 0 else -1
            drift += -1 if drift > 0 else 1
        return shares
