"""Flow-rate monitoring (reference libs/flowrate/flowrate.go).

Tracks transfer rate over a sliding EMA window; MConnection throttling
and the blocksync pool's peer-rate checks use `status().cur_rate`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass
class Status:
    start: float
    bytes_total: int
    cur_rate: float  # bytes/sec over the sample window
    avg_rate: float
    peak_rate: float
    duration: float


class Monitor:
    def __init__(self, sample_period: float = 0.1, window: float = 1.0):
        self._sample = sample_period
        self._window = window
        self._alpha = sample_period / window
        self._start = time.monotonic()
        self._total = 0
        self._acc = 0  # bytes since last sample
        self._last = self._start
        self._rate = 0.0
        self._peak = 0.0
        self._seeded = False  # EMA primes with the first sample
        # token bucket for limit(): credit accrues at the cap and is
        # clamped to one window's burst
        self._tokens = 0.0
        self._tok_time = 0.0

    def update(self, n: int) -> None:
        self._total += n
        self._acc += n
        now = time.monotonic()
        dt = now - self._last
        if dt >= self._sample:
            inst = self._acc / dt
            if not self._seeded:
                # seed with the first sample (as the reference flowrate
                # does): EMA-ing up from 0 with alpha = sample/window
                # would under-report the true rate ~window/sample-fold
                # for the first seconds — long enough to trip min-rate
                # bans against healthy peers
                self._rate = inst
                self._seeded = True
            else:
                self._rate += self._alpha * (inst - self._rate)
            self._peak = max(self._peak, self._rate)
            self._acc = 0
            self._last = now

    def status(self) -> Status:
        now = time.monotonic()
        dur = now - self._start
        # idle decay: a transfer that stops must see its cur_rate fall
        # toward zero (a stalled peer otherwise keeps its last EMA
        # forever and a min-rate check can never trip); apply the EMA
        # update as if the pending bytes arrived over the elapsed time
        # and nothing after
        rate = self._rate
        idle = now - self._last
        if self._sample > 0 and idle >= self._sample:
            steps = idle / self._sample
            inst = self._acc / idle
            if not self._seeded:
                # mirror update()'s first-sample seeding: before any
                # sample lands, the pending bytes ARE the best estimate
                rate = inst
            else:
                decay = (1.0 - self._alpha) ** steps
                rate = rate * decay + inst * (1.0 - decay)
        return Status(
            start=self._start,
            bytes_total=self._total,
            cur_rate=rate,
            avg_rate=self._total / dur if dur > 0 else 0.0,
            peak_rate=self._peak,
            duration=dur,
        )

    def limit(self, want: int, max_rate: float) -> int:
        """How many of `want` bytes may transfer now to stay under
        max_rate (0 = unlimited).

        Token bucket with the burst clamped to one window of credit
        (reference flowrate.Limit): idle or under-cap time must not bank
        unbounded credit, or a later burst streams unthrottled. A return
        value equal to `want` CONSUMES the budget (the caller transfers
        those bytes); partial grants are advisory and consume nothing
        (callers retry until the full amount fits)."""
        if max_rate <= 0:
            return want
        now = time.monotonic()
        # burst cap: one window of credit, but never below one `want` —
        # a cap smaller than a single transfer unit (e.g. send_rate
        # below one packet) must delay the transfer, not deadlock it
        burst = max(max_rate * self._window, float(want))
        if self._tok_time == 0.0:
            # start with a full bucket: small messages never wait
            self._tokens = burst
        else:
            self._tokens = min(
                self._tokens + max_rate * (now - self._tok_time), burst
            )
        self._tok_time = now
        if want <= self._tokens:
            self._tokens -= want
            return want
        return max(0, int(self._tokens))
