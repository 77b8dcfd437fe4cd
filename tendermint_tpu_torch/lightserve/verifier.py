"""ServeVerifier — shared-round, deduped skipping verification.

A thousand server-assisted light clients syncing the same chain from
the same trust root all walk the SAME bisection: every one of them asks
to verify the identical (trusted→target) hop. Run naively, that is
N × (trusting-overlap verify + full-power verify) device work for one
distinct answer. This verifier is the serving plane's amortizer:

- **in-flight dedup**: concurrent requests for the same hop share one
  underlying verification — the first request runs it, everyone else
  awaits the shared future;
- **verdict reuse window**: a completed hop verdict (success or a
  VerificationError — including the ErrNewHeaderTooFarAhead that
  drives bisection) is reusable for `reuse_window_ns` of caller `now`.
  The time-dependent checks (trusting period, future-header drift) run
  per requester against the caller's own `now` BEFORE the cache — pure
  and cheap — so the shared verdict is exclusively the now-independent
  part (signatures, trust overlap, hash chain) and a skewed or
  malicious client can't poison the swarm's cache with its clock.
  Non-verification failures (provider/device errors) are never cached;
- **the `lightserve` scheduler lane**: the commit verifies underneath
  distinct hops run in executor threads against a classed dispatch
  adapter, so concurrent DISTINCT hops coalesce into shared device
  rounds through parallel/scheduler.py — below the node's own `light`
  class, so serving external clients never delays consensus, evidence,
  blocksync, or the node's own bisection.

Loop-affine: futures and the dedup maps belong to the event loop the
requests run on (one serving plane per node/harness loop).

Reference counterpart: none — the reference light client verifies per
client, and full nodes have no server-side verify assist at all.
"""

from __future__ import annotations

import asyncio
import functools
from collections import OrderedDict
from typing import Optional

from ..libs.log import Logger, nop_logger
from ..libs.metrics import LightServeMetrics, default_metrics
from ..light.types import LightBlock
from ..light.verifier import (
    DEFAULT_MAX_CLOCK_DRIFT_NS,
    VerificationError,
    _common_checks,
    _verify_commit_full_power,
    verify as _verify,
)

DEFAULT_REUSE_WINDOW_NS = 60 * 1_000_000_000
DEFAULT_MAX_VERDICTS = 4096

_KLASS = "lightserve"


def _commit_digest(commit) -> bytes:
    """The commit's content digest for the verdict-cache key: two
    commits for the same header but different signature sets verify
    differently, so the key must distinguish them. Commit.hash() is the
    memoized merkle root over the signature encodings — on the shared
    cache-served objects the per-request cost is an attribute read.
    QC-compressed proofs (commit=None) digest empty here; their proof
    content is keyed by _qc_digest."""
    return commit.hash() if commit is not None else b""


def _qc_digest(lb) -> bytes:
    """The QuorumCertificate's content digest for the verdict-cache
    key — a qc-compressed proof verifies through a different input set
    (signer bitset + aggregate) than the same header's full commit, so
    the two must not share a verdict entry."""
    qc = getattr(lb, "qc", None)
    return qc.encode() if qc is not None else b""


class ServeVerifier:
    def __init__(
        self,
        verifier=None,
        klass: str = _KLASS,
        reuse_window_ns: int = DEFAULT_REUSE_WINDOW_NS,
        max_verdicts: int = DEFAULT_MAX_VERDICTS,
        metrics: Optional[LightServeMetrics] = None,
        logger: Optional[Logger] = None,
    ):
        self._verifier = verifier
        self.klass = klass
        self.reuse_window_ns = int(reuse_window_ns)
        self.max_verdicts = max(1, int(max_verdicts))
        self.metrics = metrics or default_metrics(LightServeMetrics)
        self.logger = logger or nop_logger()
        self._inflight: dict[tuple, asyncio.Future] = {}
        # key -> (VerificationError-or-None, now_ns the verdict was
        # computed at); bounded LRU
        self._verdicts: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.requests = 0
        self.deduped = 0
        self.executed = 0

    def _dispatch_verifier(self):
        """The commit-verify backend: an explicit verifier when injected
        (tests/bench isolation), else the process scheduler's classed
        adapter — resolved per call so a scheduler installed after
        construction is picked up."""
        if self._verifier is not None:
            return self._verifier
        from ..parallel.scheduler import default_dispatch

        return default_dispatch(self.klass)

    # --- the serving surface ------------------------------------------------

    async def verify_hop(
        self,
        trusted: LightBlock,
        untrusted: LightBlock,
        trusting_period_ns: int,
        now_ns: int,
        max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
    ) -> None:
        """One (trusted→target) verification hop — adjacent or skipping,
        same dispatch as light/verifier.verify. Raises VerificationError
        (incl. ErrNewHeaderTooFarAhead: bisect) exactly like the direct
        call; identical concurrent/recent hops share one verification.

        The time-dependent checks (trusting period, future-header drift)
        run HERE, per requester, against the caller's own `now` — cheap
        and pure, never cached. Only then does the request enter the
        shared cache, so the shared verdict is exclusively the
        now-independent part (signatures, trust overlap, hash chain):
        one clock-skewed — or malicious — client can neither poison the
        swarm with a from-the-future failure verdict nor ride a success
        verdict its own clock should reject.

        The cache key covers EVERY remaining verification input — both
        validator-set hashes and the untrusted commit digest, not just
        the header hashes — so a client submitting the real headers
        with a bogus trusted set (or a garbage commit) caches its
        failure under ITS key, never under the one honest clients
        compute."""
        _common_checks(
            trusted,
            untrusted,
            trusting_period_ns,
            now_ns,
            max_clock_drift_ns,
        )
        key = (
            "hop",
            trusted.header.hash(),
            trusted.validators.hash(),
            untrusted.header.hash(),
            untrusted.validators.hash(),
            _commit_digest(untrusted.commit),
            _qc_digest(untrusted),
            int(trusting_period_ns),
        )
        await self._run(
            key,
            now_ns,
            functools.partial(
                _verify,
                trusted,
                untrusted,
                trusting_period_ns,
                now_ns,
                max_clock_drift_ns,
                verifier=self._dispatch_verifier(),
            ),
            kind="hop",
        )

    async def verify_root(self, lb: LightBlock, now_ns: int = 0) -> None:
        """Trust-root full-power commit verify (client initialize):
        every swarm client pins the same root — one verification. Same
        complete-inputs key rule as verify_hop."""
        key = (
            "root",
            lb.header.hash(),
            lb.validators.hash(),
            _commit_digest(lb.commit),
            _qc_digest(lb),
        )
        await self._run(
            key,
            now_ns,
            functools.partial(
                _verify_commit_full_power,
                lb,
                verifier=self._dispatch_verifier(),
            ),
            kind="root",
        )

    # --- shared execution ---------------------------------------------------

    async def _run(self, key, now_ns, fn, kind: str) -> None:
        self.requests += 1
        self.metrics.verify_requests.inc(kind=kind)
        cached = self._verdicts.get(key)
        if cached is not None:
            outcome, at_ns = cached
            if abs(int(now_ns) - at_ns) <= self.reuse_window_ns:
                self._verdicts.move_to_end(key)
                self.deduped += 1
                self.metrics.verify_deduped.inc(kind=kind)
                if outcome is not None:
                    # shared instance: strip the traceback before each
                    # re-raise, or every reuse APPENDS its propagation
                    # frames to the one object and the LRU pins them
                    raise outcome.with_traceback(None)
                return
            self._verdicts.pop(key, None)
        loop = asyncio.get_running_loop()
        fut = self._inflight.get(key)
        if fut is not None:
            self.deduped += 1
            self.metrics.verify_deduped.inc(kind=kind)
        else:
            fut = loop.create_future()
            self._inflight[key] = fut
            # the verification runs in a VERIFIER-owned task, not the
            # first requester's: any client's sync — including the one
            # that triggered the work — can be cancelled without
            # aborting the verification the other waiters share
            loop.create_task(self._execute(key, now_ns, fn, kind, fut))
        # shield: a waiter's own cancellation detaches it from the
        # shared future without cancelling it
        outcome = await asyncio.shield(fut)
        if outcome is not None:
            raise outcome.with_traceback(None)

    async def _execute(self, key, now_ns, fn, kind: str, fut) -> None:
        outcome: Optional[BaseException] = None
        try:
            try:
                # executor thread: the classed adapter's blocking bridge
                # (scheduler.submit_sync) only engages OFF the loop, and
                # the device round must not freeze other clients
                await asyncio.get_running_loop().run_in_executor(None, fn)
            except VerificationError as e:
                outcome = e
            self.executed += 1
            self.metrics.verify_executed.inc(kind=kind)
            self._verdicts[key] = (outcome, int(now_ns))
            while len(self._verdicts) > self.max_verdicts:
                self._verdicts.popitem(last=False)
        except BaseException as e:
            # non-verification failure (provider/device error, loop
            # teardown): fail every waiter, cache nothing — the next
            # request retries. Failures travel as the future's RESULT
            # so an un-awaited future never logs "exception was never
            # retrieved".
            outcome = (
                e
                if isinstance(e, Exception)
                else RuntimeError(f"serve verification aborted: {e!r}")
            )
        finally:
            self._inflight.pop(key, None)
            if not fut.done():
                fut.set_result(outcome)

    # --- introspection ------------------------------------------------------

    def dedup_rate(self) -> float:
        return self.deduped / self.requests if self.requests else 0.0

    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "deduped": self.deduped,
            "executed": self.executed,
            "dedup_rate": round(self.dedup_rate(), 4),
        }
