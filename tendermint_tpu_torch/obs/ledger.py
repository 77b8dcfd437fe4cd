"""Device-cost ledger — per-class accelerator accounting for the
unified dispatch scheduler.

The paper's premise is that committee crypto is the dominant cost and
the accelerator is the scarce resource, yet until this module the stack
could count dispatches and shapes (crypto/shape_registry) but not say
WHICH subsystem spent WHICH device milliseconds at WHAT fill
efficiency. The ledger closes that: `parallel/scheduler.py` records
every coalesced round here as a structured entry, and the ledger rolls
the stream into:

- **per-class device-time shares**: a round's device-execute seconds
  are attributed to its submitter classes proportionally to the rows
  each class contributed (an fn-lane round is single-class and books
  whole). This is the accounting substrate the verify-as-a-service
  topology (ROADMAP item 2) bills against — a multi-tenant scheduler
  is un-debuggable and un-fair without it;
- **fill-efficiency distributions**: per-round fill = rows-requested /
  rows-dispatched (the padded bucket). A saturated scheduler running
  10%-full buckets is a misconfiguration (mesh_min_rows / ladder /
  max_batch), and fill is the knob that prices it;
- **padding-waste totals**: dispatched-minus-requested rows — device
  work bought and thrown away, the direct cost of shape discipline;
- **requests-per-dispatch amortization**: submissions merged per round,
  cumulative and bucketed by round size, so the amortization curve
  (tools/device_report.py) shows where coalescing actually pays.

Determinism and shape follow `obs/health.py`: every entry takes an
explicit event time `t` (the scheduler stamps its own perf_counter
values); nothing here reads a clock. Stdlib only, thread-safe (the
scheduler records from its event loop; bench/RPC/soak read from
other threads).

Accounting truth lives in the CUMULATIVE totals, which never cap; the
bounded entry ring is a recent-detail view (the RPC dump's `entries`,
and the fill percentiles, which are computed over retained entries).
The scheduler's `dispatch_log` deque is telemetry only — a reader of its stats
hits its 1024-cap; read this ledger instead.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from .report import pct

# entry ring default: enough to hold several bench families' worth of
# rounds; totals are exact regardless
DEFAULT_ENTRY_RING = 4096


class _ClassAccount:
    __slots__ = (
        "rows", "device_seconds", "queue_wait_seconds", "rounds",
        "submissions",
    )

    def __init__(self):
        self.rows = 0
        self.device_seconds = 0.0
        self.queue_wait_seconds = 0.0
        self.rounds = 0
        self.submissions = 0

    def to_json(self) -> dict:
        return {
            "rows": self.rows,
            "device_seconds": round(self.device_seconds, 6),
            "queue_wait_seconds": round(self.queue_wait_seconds, 6),
            "rounds": self.rounds,
            "submissions": self.submissions,
        }


class DispatchLedger:
    """Structured record of every coalesced scheduler round + rolling
    per-class/per-bucket accounting. One per process by default
    (`default_ledger()`, the shape-registry pattern); tests isolate
    with their own instance."""

    def __init__(self, max_entries: int = DEFAULT_ENTRY_RING):
        self._lock = threading.Lock()
        self._entries: deque[dict] = deque(maxlen=max(1, int(max_entries)))
        self._seq = 0  # id of the NEXT entry; monotonic, never reused
        # cumulative totals (never capped — the accounting truth)
        self._rounds = 0
        self._fn_rounds = 0
        self._sharded_rounds = 0
        self._rows_requested = 0  # sig rounds only (fn rows below)
        self._rows_dispatched = 0  # padded bucket rows, sig rounds only
        self._fn_rows = 0
        self._submissions = 0
        self._device_seconds = 0.0
        self._queue_wait_seconds = 0.0
        self._host_prep_seconds = 0.0
        self._per_class: dict[str, _ClassAccount] = {}
        # engine -> {rounds, submissions, rows_requested,
        # rows_dispatched, device_seconds}: the honest
        # requests-per-dispatch axis. The GLOBAL rpd is structurally
        # diluted by one-submission fn rounds (every bls_agg round is
        # exactly one submission by construction), so the coalescing
        # claim reads per-engine — "sig" is the coalesced ed25519
        # plane, named engines (bls_agg, qc_verify, secp_recover) and
        # anonymous "fn" closures each get their own row
        self._per_engine: dict[str, dict] = {}
        # bucket -> {rounds, rows_requested, submissions}: the
        # amortization curve's x-axis (bounded by the ladder + its
        # multiples, not by traffic)
        self._by_bucket: dict[int, dict] = {}

    # --- recording (scheduler's event loop) ------------------------------

    def record_round(
        self,
        t: float,
        *,
        class_rows: dict,
        requested: int,
        dispatched: int,
        devices: int = 1,
        submissions: int = 1,
        class_subs: Optional[dict] = None,
        queue_wait_s: float = 0.0,
        class_queue_wait: Optional[dict] = None,
        host_prep_s: float = 0.0,
        device_s: float = 0.0,
        engine: str = "sig",
    ) -> None:
        """Book one device round. `class_rows` maps submitter class ->
        rows it contributed (requested, pre-padding); `requested` is
        their sum, `dispatched` the padded bucket actually sent to the
        device (== requested for fn-lane rounds, which pad internally).
        `t` is the caller's event time for the dispatch start — the
        ledger never reads a clock. `class_subs`/`class_queue_wait`
        optionally map class -> merged-submission count / summed
        enqueue->dispatch wait."""
        requested = int(requested)
        dispatched = max(int(dispatched), requested)
        # every engine other than the coalesced ed25519 plane is an
        # fn-lane round (anonymous closures book as "fn"; wire engines
        # carry their name) — its rows/fill live on the fn axis
        fn = engine != "sig"
        fill = (requested / dispatched) if dispatched else 0.0
        # normalize the optional per-class maps once: a single-class
        # round's submissions/wait belong to that class even when the
        # caller didn't spell it out — recording (cumulative AND entry)
        # then uses one rule, so span rebuilds match the totals
        if class_subs is None:
            class_subs = (
                {next(iter(class_rows)): int(submissions)}
                if len(class_rows) == 1 else {}
            )
        if class_queue_wait is None:
            class_queue_wait = (
                {next(iter(class_rows)): queue_wait_s}
                if len(class_rows) == 1 else {}
            )
        entry = {
            "seq": 0,  # patched under the lock
            "t": round(t, 6),
            "engine": engine,
            "classes": sorted(class_rows),
            "rows": {k: int(v) for k, v in class_rows.items()},
            "subs": {k: int(v) for k, v in class_subs.items()},
            "wait": {
                k: round(v, 6) for k, v in class_queue_wait.items()
            },
            "requested": requested,
            "dispatched": dispatched,
            "fill": round(fill, 4),
            "devices": int(devices),
            "sharded": devices > 1,
            "submissions": int(submissions),
            "queue_wait_s": round(queue_wait_s, 6),
            "host_prep_s": round(host_prep_s, 6),
            "device_s": round(device_s, 6),
        }
        with self._lock:
            entry["seq"] = self._seq
            self._seq += 1
            self._entries.append(entry)
            self._rounds += 1
            if fn:
                self._fn_rounds += 1
                self._fn_rows += requested
            else:
                self._rows_requested += requested
                self._rows_dispatched += dispatched
            eng = self._per_engine.get(engine)
            if eng is None:
                eng = self._per_engine[engine] = {
                    "rounds": 0, "submissions": 0, "rows_requested": 0,
                    "rows_dispatched": 0, "device_seconds": 0.0,
                }
            eng["rounds"] += 1
            eng["submissions"] += int(submissions)
            eng["rows_requested"] += requested
            eng["rows_dispatched"] += dispatched
            eng["device_seconds"] += device_s
            if devices > 1:
                self._sharded_rounds += 1
            self._submissions += int(submissions)
            self._device_seconds += device_s
            self._queue_wait_seconds += queue_wait_s
            self._host_prep_seconds += host_prep_s
            for klass, rows in class_rows.items():
                acct = self._per_class.get(klass)
                if acct is None:
                    acct = self._per_class[klass] = _ClassAccount()
                acct.rows += int(rows)
                acct.rounds += 1
                # device time attributed by row share (fn/single-class
                # rounds book whole: rows == requested)
                if requested > 0:
                    acct.device_seconds += device_s * (rows / requested)
                acct.queue_wait_seconds += class_queue_wait.get(klass, 0.0)
                acct.submissions += int(class_subs.get(klass, 0))
            if not fn:
                b = self._by_bucket.get(dispatched)
                if b is None:
                    b = self._by_bucket[dispatched] = {
                        "rounds": 0, "rows_requested": 0, "submissions": 0,
                    }
                b["rounds"] += 1
                b["rows_requested"] += requested
                b["submissions"] += int(submissions)

    # --- reading ----------------------------------------------------------

    def totals(self) -> dict:
        """Cumulative scalar totals (the health plane's pull seam reads
        interval deltas of these)."""
        with self._lock:
            return {
                "seq": self._seq,
                "rounds": self._rounds,
                "fn_rounds": self._fn_rounds,
                "sharded_rounds": self._sharded_rounds,
                "rows_requested": self._rows_requested,
                "rows_dispatched": self._rows_dispatched,
                "fn_rows": self._fn_rows,
                "submissions": self._submissions,
                "device_seconds": self._device_seconds,
                "queue_wait_seconds": self._queue_wait_seconds,
                "host_prep_seconds": self._host_prep_seconds,
            }

    def mark(self) -> dict:
        """Opaque position for `summary(since=...)` — bench families
        bracket a run with mark()/summary() the way they bracket the
        shape registry with snapshot()/delta()."""
        return self.totals()

    def entries(self, since_seq: int = 0, limit: int = 0) -> list[dict]:
        """Retained entries with seq >= since_seq (ring-bounded; the
        newest `limit` when limit > 0)."""
        with self._lock:
            out = [e for e in self._entries if e["seq"] >= since_seq]
        if limit > 0:
            out = out[-limit:]
        return out

    def summary(self, since: Optional[dict] = None) -> dict:
        """The `device_cost` block: per-class device-seconds/rows/share,
        fill-efficiency p50/p95, padding-waste rows, and the
        requests-per-dispatch amortization — over the whole ledger, or
        the span since a `mark()` when given.

        Totals in the block are EXACT over the span (cumulative-counter
        deltas). The fill percentiles and per-bucket curve come from
        retained ring entries; `fill_window_truncated` flags a span
        whose older rounds aged out of the ring."""
        now = self.totals()
        base = since or {}
        since_seq = int(base.get("seq", 0))
        span = self.entries(since_seq=since_seq)
        # fill percentiles are a SIG-plane distribution: fn engines'
        # internal buckets are honest now, but blending a 0.59-full
        # bls_agg aggregate with a 0.95-full ed25519 bucket prices
        # nothing — each plane reads its own axis (per_engine below)
        sig_fills = sorted(e["fill"] for e in span if e["engine"] == "sig")
        rounds = now["rounds"] - base.get("rounds", 0)
        fn_rounds = now["fn_rounds"] - base.get("fn_rounds", 0)
        requested = now["rows_requested"] - base.get("rows_requested", 0)
        dispatched = now["rows_dispatched"] - base.get("rows_dispatched", 0)
        submissions = now["submissions"] - base.get("submissions", 0)
        device_s = now["device_seconds"] - base.get("device_seconds", 0.0)
        per_class: dict[str, dict] = {}
        per_engine: dict[str, dict] = {}
        if since is None:
            with self._lock:
                per_class = {
                    k: v.to_json() for k, v in self._per_class.items()
                }
                per_engine = {
                    k: dict(v) for k, v in self._per_engine.items()
                }
        else:
            # span view: rebuild per-class from retained entries (exact
            # when the ring held the whole span; flagged below when not)
            accts: dict[str, _ClassAccount] = {}
            for e in span:
                e_req = e["requested"] or 1
                for klass, rows in e["rows"].items():
                    acct = accts.setdefault(klass, _ClassAccount())
                    acct.rows += rows
                    acct.rounds += 1
                    acct.device_seconds += e["device_s"] * (rows / e_req)
                    acct.submissions += e["subs"].get(klass, 0)
                    acct.queue_wait_seconds += e["wait"].get(klass, 0.0)
            per_class = {k: v.to_json() for k, v in accts.items()}
            for e in span:
                eng = per_engine.setdefault(
                    e["engine"],
                    {"rounds": 0, "submissions": 0, "rows_requested": 0,
                     "rows_dispatched": 0, "device_seconds": 0.0},
                )
                eng["rounds"] += 1
                eng["submissions"] += e["submissions"]
                eng["rows_requested"] += e["requested"]
                eng["rows_dispatched"] += e["dispatched"]
                eng["device_seconds"] += e["device_s"]
        for entry in per_class.values():
            entry["device_share"] = round(
                entry["device_seconds"] / device_s, 4
            ) if device_s > 0 else 0.0
        for eng in per_engine.values():
            eng["device_seconds"] = round(eng["device_seconds"], 6)
            eng["fill_ratio"] = round(
                eng["rows_requested"] / eng["rows_dispatched"], 4
            ) if eng["rows_dispatched"] else 0.0
            eng["requests_per_dispatch"] = round(
                eng["submissions"] / eng["rounds"], 3
            ) if eng["rounds"] else 0.0
        by_bucket: dict[int, dict] = {}
        for e in span:
            if e["engine"] != "sig":
                continue
            b = by_bucket.setdefault(
                e["dispatched"],
                {"rounds": 0, "rows_requested": 0, "submissions": 0},
            )
            b["rounds"] += 1
            b["rows_requested"] += e["requested"]
            b["submissions"] += e["submissions"]
        return {
            "rounds": rounds,
            "fn_rounds": fn_rounds,
            "sharded_rounds": (
                now["sharded_rounds"] - base.get("sharded_rounds", 0)
            ),
            "rows_requested": requested,
            "rows_dispatched": dispatched,
            "fn_rows": now["fn_rows"] - base.get("fn_rows", 0),
            "padding_rows": max(0, dispatched - requested),
            "fill_ratio": round(requested / dispatched, 4) if dispatched
            else 0.0,
            "fill_ratio_p50": round(pct(sig_fills, 0.50), 4),
            "fill_ratio_p95": round(pct(sig_fills, 0.95), 4),
            "requests_per_dispatch": round(submissions / rounds, 3)
            if rounds else 0.0,
            "per_engine": dict(sorted(per_engine.items())),
            "device_seconds": round(device_s, 6),
            "queue_wait_seconds": round(
                now["queue_wait_seconds"]
                - base.get("queue_wait_seconds", 0.0), 6
            ),
            "host_prep_seconds": round(
                now["host_prep_seconds"]
                - base.get("host_prep_seconds", 0.0), 6
            ),
            "per_class": dict(sorted(per_class.items())),
            "by_bucket": {
                str(b): v for b, v in sorted(by_bucket.items())
            },
            "fill_window_truncated": len(span) < rounds,
        }


_default: Optional[DispatchLedger] = None
_default_lock = threading.Lock()


def default_ledger() -> DispatchLedger:
    """Process-wide ledger every VerifyScheduler records into unless
    handed an explicit one (tests isolate with their own instance) —
    the default-shape-registry pattern, so bench/soak capture every
    scheduler in the process with one mark()/summary() pair."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = DispatchLedger()
    return _default


def set_default_ledger(
    ledger: Optional[DispatchLedger],
) -> Optional[DispatchLedger]:
    """Install `ledger` as the process default (None resets to a fresh
    one on next access)."""
    global _default
    with _default_lock:
        _default = ledger
    return ledger
