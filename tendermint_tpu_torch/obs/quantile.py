"""Streaming quantile sketch — fixed-window order statistics.

The pacing controllers (consensus/pacing.py) learn live arrival-tail
distributions from the quorum-lag sensors; the bench family computes
quorum-close p50/p95 from the same math. Both need a quantile estimate
that is

- *streaming*: O(1) per sample, bounded memory — the vote hot path
  feeds it synchronously;
- *windowed*: consensus latency is non-stationary (a link degrades, a
  partition heals), so old samples must age out instead of pinning the
  estimate forever;
- *deterministic*: two identical sample streams must produce identical
  estimates — the pacing determinism test (two nodes replaying the same
  trace must derive the same timeout schedule) rules out randomized
  sketches.

Exact order statistics over a bounded ring satisfy all three (a P²
estimator would too, but its estimates depend on the full history, so a
window bound would have to be bolted on; the ring IS the window). The
sort is amortized: samples append O(1) and the sorted view is rebuilt
lazily per query batch, so a feed-heavy/query-light caller (hundreds of
votes per height, one schedule decision) pays one O(w log w) sort per
decision, w <= window.

The quantile index rule matches `obs.report.pct` (sorted[min(n-1,
int(q*n))]) so a sketch over the full sample list and the ad-hoc list
math agree bit-for-bit.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional


class StreamingQuantile:
    """Quantiles over the last `window` samples (exact within window)."""

    __slots__ = ("_ring", "_sorted", "count")

    def __init__(self, window: int = 256):
        if window < 1:
            raise ValueError("quantile window must be >= 1")
        self._ring: deque[float] = deque(maxlen=window)
        self._sorted: Optional[list[float]] = None  # lazy cache
        self.count = 0  # total samples ever added (not just windowed)

    @property
    def window(self) -> int:
        return self._ring.maxlen or 0

    def add(self, x: float) -> None:
        self._ring.append(float(x))
        self._sorted = None
        self.count += 1

    def extend(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.add(x)

    def __len__(self) -> int:
        return len(self._ring)

    def _view(self) -> list[float]:
        if self._sorted is None:
            self._sorted = sorted(self._ring)
        return self._sorted

    def quantile(self, q: float) -> float:
        """The q-quantile of the window (0.0 when empty). Same index
        rule as obs.report.pct."""
        xs = self._view()
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def quantiles(self, qs: Iterable[float]) -> list[float]:
        """Several quantiles off one sorted view."""
        return [self.quantile(q) for q in qs]

    def max(self) -> float:
        xs = self._view()
        return xs[-1] if xs else 0.0

    def reset(self) -> None:
        self._ring.clear()
        self._sorted = None
        self.count = 0

    # --- persistence (pacing-tail warm starts) ----------------------------

    def to_list(self) -> list[float]:
        """The windowed samples in arrival order — with `count`, the
        sketch's full restorable state."""
        return list(self._ring)

    def load(self, samples: Iterable[float], count: int = 0) -> None:
        """Restore a persisted window (consensus/pacing.py warm start).
        Replaces the current contents; `count` restores the lifetime
        tally (defaults to the window length so min_samples gating
        still sees the restored evidence)."""
        self._ring.clear()
        for x in samples:
            self._ring.append(float(x))
        self._sorted = None
        self.count = max(int(count), len(self._ring))

    def snapshot(self) -> dict:
        """Summary dict for reports/tests (p50/p95/p99/max/counts)."""
        return {
            "count": self.count,
            "window_fill": len(self._ring),
            "p50": self.quantile(0.5),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "max": self.max(),
        }
