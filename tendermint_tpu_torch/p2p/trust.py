"""Peer trust metric — PD-controller score over good/bad behavior.

Reference: p2p/trust/metric.go + store.go. The math is reproduced:

    value = w_P * P + w_I * H + gamma(d) * d
    P = good / (good + bad)            (current interval)
    H = faded-memory weighted history  (integral)
    d = P - H                          (derivative; gamma1=0 when rising,
                                        gamma2=1 when falling — bad news
                                        is acted on immediately)

History uses the reference's "faded memories": m history slots cover 2^m
intervals; on each interval rollover every older slot absorbs its newer
neighbor with weight (2^c - 1)/2^c (metric.go:387-404 updateFadedMemory),
and slot weights decay by 0.8^i (defaultHistoryDataWeight).

Intervals advance by explicit `tick()` (the store's background task) so
tests control time without a clock.
"""

from __future__ import annotations

import json
import math
import os

DEFAULT_PROPORTIONAL_WEIGHT = 0.4
DEFAULT_INTEGRAL_WEIGHT = 0.6
DEFAULT_HISTORY_DATA_WEIGHT = 0.8
DERIVATIVE_GAMMA_RISING = 0.0
DERIVATIVE_GAMMA_FALLING = 1.0
DEFAULT_NUM_INTERVALS = 8  # history slots -> 2^8 intervals of memory


class TrustMetric:
    def __init__(
        self,
        proportional_weight: float = DEFAULT_PROPORTIONAL_WEIGHT,
        integral_weight: float = DEFAULT_INTEGRAL_WEIGHT,
        num_intervals: int = DEFAULT_NUM_INTERVALS,
    ):
        self.pw = proportional_weight
        self.iw = integral_weight
        self.max_history = num_intervals
        self.good = 0.0
        self.bad = 0.0
        self.history: list[float] = []
        self.history_value = 1.0
        self.num_intervals = 0
        self.paused = False

    # --- events -----------------------------------------------------------

    def good_event(self, n: float = 1.0) -> None:
        self._unpause()
        self.good += n

    def bad_event(self, n: float = 1.0) -> None:
        self._unpause()
        self.bad += n

    def pause(self) -> None:
        """Stop counting time against a disconnected peer (metric.go
        Pause); the next event resumes with fresh interval counters."""
        self.paused = True

    def _unpause(self) -> None:
        if self.paused:
            self.good = 0.0
            self.bad = 0.0
            self.paused = False

    # --- value ------------------------------------------------------------

    def _proportional(self) -> float:
        total = self.good + self.bad
        return self.good / total if total > 0 else 1.0

    def _weighted_derivative(self) -> float:
        d = self._proportional() - self.history_value
        gamma = (
            DERIVATIVE_GAMMA_FALLING if d < 0 else DERIVATIVE_GAMMA_RISING
        )
        return gamma * d

    def value(self) -> float:
        """Current trust in [0, 1] (metric.go:323 calcTrustValue)."""
        if self.paused:
            return max(0.0, self.history_value)
        v = (
            self.pw * self._proportional()
            + self.iw * self.history_value
            + self._weighted_derivative()
        )
        return max(0.0, min(1.0, v))

    # --- interval rollover (metric.go:206-247 NextTimeInterval) -----------

    def tick(self) -> None:
        if self.paused:
            return
        new_hist = (
            self.pw * self._proportional() + self.iw * self.history_value
        )
        if len(self.history) == self.max_history:
            self._update_faded_memory()
            self.history[-1] = new_hist
        else:
            self.history.append(new_hist)
        self.num_intervals += 1
        self.good = 0.0
        self.bad = 0.0
        self.history_value = self._calc_history_value()

    def _update_faded_memory(self) -> None:
        end = len(self.history) - 1
        for count in range(1, len(self.history)):
            i = end - count
            x = 2.0**count
            self.history[i] = (
                self.history[i] * (x - 1) + self.history[i + 1]
            ) / x

    def _calc_history_value(self) -> float:
        """Weighted sum over the intervals the slots represent
        (metric.go:363-385: slot for interval i is floor(log2(i)))."""
        n = min(self.num_intervals, 2 ** len(self.history) - 1) or 1
        hv = 0.0
        wsum = 0.0
        first = len(self.history) - 1
        for i in range(min(n, 2 ** len(self.history))):
            offset = 0 if i == 0 else int(math.floor(math.log2(i))) + 1
            idx = max(0, first - offset)
            w = DEFAULT_HISTORY_DATA_WEIGHT**i
            hv += self.history[idx] * w
            wsum += w
        return hv / wsum if wsum else 1.0

    # --- persistence ------------------------------------------------------

    def to_json(self) -> dict:
        return {
            "history": self.history,
            "history_value": self.history_value,
            "num_intervals": self.num_intervals,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TrustMetric":
        tm = cls()
        tm.history = list(d.get("history", []))
        tm.history_value = d.get("history_value", 1.0)
        tm.num_intervals = d.get("num_intervals", 0)
        return tm


class TrustMetricStore:
    """Per-peer metrics + periodic persistence (p2p/trust/store.go)."""

    def __init__(self, path: str = ""):
        self._path = path
        self._metrics: dict[str, TrustMetric] = {}
        if path and os.path.exists(path):
            self._load()

    def get_metric(self, peer_id: str) -> TrustMetric:
        tm = self._metrics.get(peer_id)
        if tm is None:
            tm = TrustMetric()
            self._metrics[peer_id] = tm
        return tm

    def peer_disconnected(self, peer_id: str) -> None:
        tm = self._metrics.get(peer_id)
        if tm is not None:
            tm.pause()

    def tick_all(self) -> None:
        for tm in self._metrics.values():
            tm.tick()

    def size(self) -> int:
        return len(self._metrics)

    def save(self) -> None:
        if not self._path:
            return
        os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {pid: tm.to_json() for pid, tm in self._metrics.items()},
                f,
            )
        os.replace(tmp, self._path)

    def _load(self) -> None:
        with open(self._path) as f:
            data = json.load(f)
        for pid, d in data.items():
            self._metrics[pid] = TrustMetric.from_json(d)
