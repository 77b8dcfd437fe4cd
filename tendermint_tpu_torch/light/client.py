"""Light client — header verification by trust propagation.

Reference: light/client.go. The client tracks a trusted store, a primary
provider and witnesses:

- `verify_light_block_at_height` (:474): sequential (:613) or skipping
  (:706, bisection) verification, producing a trace;
- divergence detection against witnesses after every skipping verify
  (light/detector.go:28 detectDivergence) with LightClientAttackEvidence
  construction on a real fork (:408);
- backwards verification for heights below the trusted head (:933);
- primary replacement from the witness set on failure (:1046);
- store pruning (:881).

Commit verifications inside run as device batches through
ValidatorSet.verify_commit_light / _trusting — the "bisection across 100k
heights, 10k-validator commits" bulk workload (BASELINE config 5).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from ..libs.log import Logger, nop_logger
from ..types.evidence import LightClientAttackEvidence
from .store import LightStore
from .types import LightBlock, Provider
from .verifier import (
    DEFAULT_MAX_CLOCK_DRIFT_NS,
    ErrNewHeaderTooFarAhead,
    VerificationError,
    verify as _verify,
    verify_non_adjacent,
)

# pivot fraction for bisection (reference client.go verifySkippingNumerator/
# Denominator = 1/2)
_PIVOT_NUM, _PIVOT_DEN = 1, 2

DEFAULT_PRUNING_SIZE = 1000


class LightClientError(Exception):
    pass


class ErrNoProviderBlock(LightClientError):
    """No provider (primary or witness) has the requested height — often
    a height the chain simply hasn't produced yet; retryable."""


class ErrNoWitnesses(LightClientError):
    pass


class ErrLightClientAttack(LightClientError):
    def __init__(self, evidence: LightClientAttackEvidence):
        super().__init__("light client attack detected")
        self.evidence = evidence


@dataclass
class TrustOptions:
    """Reference light.TrustOptions: subjective initialization root."""

    period_ns: int
    height: int
    hash: bytes


class LightClient:
    def __init__(
        self,
        chain_id: str,
        trust_options: Optional[TrustOptions],
        primary: Provider,
        witnesses: list[Provider],
        store: LightStore,
        trusting_period_ns: int = 0,
        max_clock_drift_ns: int = DEFAULT_MAX_CLOCK_DRIFT_NS,
        sequential: bool = False,
        pruning_size: int = DEFAULT_PRUNING_SIZE,
        now_ns=None,
        serve_verifier=None,
        logger: Optional[Logger] = None,
    ):
        self.chain_id = chain_id
        self.primary = primary
        self.witnesses = list(witnesses)
        self.store = store
        self.trust_options = trust_options
        # server-assisted mode (tendermint_tpu_torch/lightserve): hop and
        # trust-root verifications are delegated to a shared
        # ServeVerifier so identical verifications across a client swarm
        # dedupe and coalesce into shared device rounds; None keeps the
        # self-verifying path
        self.serve_verifier = serve_verifier
        self.trusting_period_ns = trusting_period_ns or (
            trust_options.period_ns if trust_options else 0
        )
        self.max_clock_drift_ns = max_clock_drift_ns
        self.sequential = sequential
        self.pruning_size = pruning_size
        self.logger = logger or nop_logger()
        import time as _t

        self.now_ns = now_ns or _t.time_ns

    async def _off_loop(self, fn, *args, **kwargs):
        """Run one blocking commit verification in an executor thread:
        the device round must not freeze provider I/O, and the process
        dispatch scheduler's blocking bridge only engages off the event
        loop — this is what lets bisection batches coalesce with (and
        yield priority to) consensus/blocksync verify work."""
        import functools

        return await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(fn, *args, **kwargs)
        )

    async def _hop_verify(
        self, trusted: LightBlock, untrusted: LightBlock, now: int
    ) -> None:
        """One trusted→untrusted verification hop: through the shared
        serve verifier when server-assisted (deduped across the swarm),
        else self-verified off-loop."""
        if self.serve_verifier is not None:
            await self.serve_verifier.verify_hop(
                trusted,
                untrusted,
                self.trusting_period_ns,
                now,
                self.max_clock_drift_ns,
            )
        else:
            await self._off_loop(
                _verify,
                trusted,
                untrusted,
                self.trusting_period_ns,
                now,
                self.max_clock_drift_ns,
            )

    # --- initialization (reference :267-402) --------------------------------

    async def initialize(self) -> LightBlock:
        """Restore from the trusted store, or fetch+pin the trust root.

        When trust options are supplied alongside a non-empty store, the
        stored chain is checked against the new root: a hash mismatch at
        the trust height wipes the store and re-initializes (reference
        checkTrustedHeaderUsingOptions :303 — the operator's recovery path
        after an attack is restarting with a fresh trust root)."""
        trusted = self.store.latest()
        if trusted is not None:
            opts = self.trust_options
            if opts is not None:
                stored_at_root = self.store.get(opts.height)
                if (
                    stored_at_root is not None
                    and stored_at_root.header.hash() != opts.hash
                ):
                    self.logger.info(
                        "stored chain conflicts with new trust root; wiping"
                    )
                    for h in self.store.heights():
                        self.store.delete(h)
                    trusted = None
            if trusted is not None:
                return trusted
        if self.trust_options is None:
            raise LightClientError("no trusted store and no trust options")
        lb = await self.primary.light_block(self.trust_options.height)
        if lb is None:
            raise LightClientError("primary has no block at trust height")
        if lb.header.hash() != self.trust_options.hash:
            raise LightClientError(
                "header at trust height does not match the trusted hash"
            )
        lb.validate_basic(self.chain_id)
        # 2/3 of its own validator set must have signed (reference :369)
        if self.serve_verifier is not None:
            await self.serve_verifier.verify_root(lb, now_ns=self.now_ns())
        else:
            from .verifier import _verify_commit_full_power

            await self._off_loop(_verify_commit_full_power, lb)
        # cross-check the root with all witnesses (reference :1131)
        await self._compare_with_witnesses(lb)
        self.store.save(lb)
        return lb

    # --- queries ------------------------------------------------------------

    def trusted_light_block(self, height: int) -> Optional[LightBlock]:
        return self.store.get(height)

    def last_trusted_height(self) -> int:
        lb = self.store.latest()
        return lb.height if lb else 0

    # --- main entry (reference :474-556) ------------------------------------

    async def verify_light_block_at_height(
        self, height: int, now_ns: Optional[int] = None
    ) -> LightBlock:
        now = now_ns if now_ns is not None else self.now_ns()
        got = self.store.get(height)
        if got is not None:
            return got
        trusted = await self.initialize()

        if height < trusted.height:
            return await self._backwards(trusted, height)

        new_block = await self._block_from_primary(height)
        # pre-build the verify tables for both endpoint sets in an
        # executor thread before the bisection loop: every step is two
        # >=set-size commit verifies, and the big-tier fixed-window build
        # must not run inline in the first one.
        # Server-assisted clients skip it — their verification runs on
        # the serving plane's already-warm verifier, and a thousand
        # swarm clients each warming a private table set would serialize
        # the swarm behind one bulk build
        if self.serve_verifier is None:
            await self._warm_sets(trusted, new_block)
        if self.sequential:
            trace = await self._verify_sequential(trusted, new_block, now)
        else:
            trace = await self._verify_skipping(trusted, new_block, now)
            # divergence detection over the skipping trace
            # (reference verifySkippingAgainstPrimary + detectDivergence)
            await self._detect_divergence(trace, now)
        for lb in trace[1:]:
            self.store.save(lb)
        self.store.prune(self.pruning_size)
        return new_block

    async def _warm_sets(self, *light_blocks) -> None:
        """Bulk-warm the verifier table cache for the given blocks'
        validator sets, off the event loop. Best-effort; dedup is inside
        the cache (ensure() is idempotent per pubkey)."""
        from ..crypto.batch_verifier import warm_validator_sets_in_executor

        fut = warm_validator_sets_in_executor(
            [lb.validators for lb in light_blocks if lb is not None],
            logger=self.logger,
        )
        if fut is not None:
            try:
                await fut
            except Exception:
                pass  # already logged; verification retries the build

    # --- sequential (reference :613) ----------------------------------------

    async def _verify_sequential(
        self, trusted: LightBlock, new_block: LightBlock, now: int
    ) -> list[LightBlock]:
        trace = [trusted]
        verified = trusted
        for h in range(trusted.height + 1, new_block.height):
            interim = await self._block_from_primary(h)
            # adjacent hops ride _hop_verify too (verify() dispatches on
            # adjacency), so a sequential swarm dedupes like a skipping
            # one — but sequential mode's guarantee IS adjacency:
            # a primary answering the wrong height must fail outright,
            # never silently downgrade to 1/3-trust skipping verification
            if interim.height != verified.height + 1:
                raise VerificationError(
                    f"sequential verification: primary returned height "
                    f"{interim.height}, want {verified.height + 1}"
                )
            await self._hop_verify(verified, interim, now)
            verified = interim
            trace.append(interim)
        if new_block.height != verified.height + 1:
            raise VerificationError(
                f"sequential verification: target height "
                f"{new_block.height} is not adjacent to "
                f"{verified.height}"
            )
        await self._hop_verify(verified, new_block, now)
        trace.append(new_block)
        return trace

    # --- skipping / bisection (reference :706-775) --------------------------

    async def _verify_skipping(
        self, trusted: LightBlock, new_block: LightBlock, now: int
    ) -> list[LightBlock]:
        block_cache = [new_block]
        depth = 0
        verified = trusted
        trace = [trusted]
        while True:
            try:
                await self._hop_verify(verified, block_cache[depth], now)
            except ErrNewHeaderTooFarAhead:
                # bisect: fetch the midpoint block
                if depth == len(block_cache) - 1:
                    pivot = (
                        verified.height
                        + (block_cache[depth].height - verified.height)
                        * _PIVOT_NUM
                        // _PIVOT_DEN
                    )
                    interim = await self._block_from_primary(pivot)
                    block_cache.append(interim)
                depth += 1
                continue
            except VerificationError as e:
                raise LightClientError(
                    f"verification failed {verified.height} -> "
                    f"{block_cache[depth].height}: {e}"
                ) from e
            if depth == 0:
                trace.append(new_block)
                return trace
            verified = block_cache[depth]
            block_cache = block_cache[:depth]
            depth = 0
            trace.append(verified)

    # --- backwards (reference :933) -----------------------------------------

    async def _backwards(
        self, trusted: LightBlock, height: int
    ) -> LightBlock:
        verified = trusted
        while verified.height > height:
            interim = await self._block_from_primary(verified.height - 1)
            # hash-chain check: trusted.LastBlockID must point at interim
            if verified.header.last_block_id.hash != interim.header.hash():
                raise LightClientError(
                    f"backwards verification failed at height "
                    f"{interim.height}: broken hash chain"
                )
            if interim.header.time_ns >= verified.header.time_ns:
                raise LightClientError(
                    "backwards verification failed: non-monotonic time"
                )
            self.store.save(interim)
            verified = interim
        return verified

    # --- divergence detection (reference detector.go:28-113) ----------------

    async def _detect_divergence(
        self, primary_trace: list[LightBlock], now: int
    ) -> None:
        if len(primary_trace) < 2:
            return
        if not self.witnesses:
            raise ErrNoWitnesses("no witnesses configured")
        last = primary_trace[-1]
        results = await asyncio.gather(
            *(w.light_block(last.height) for w in self.witnesses),
            return_exceptions=True,
        )
        header_matched = False
        conflicting: list[tuple[int, LightBlock]] = []
        for i, res in enumerate(results):
            if isinstance(res, BaseException) or res is None:
                # benign: witness unavailable / doesn't have the block
                continue
            if res.header.hash() == last.header.hash():
                header_matched = True
                continue
            conflicting.append((i, res))
        # conflicting headers: verify each witness's chain through the
        # divergence point and build attack evidence (reference
        # handleConflictingHeaders :217). Examinations run concurrently
        # — per-sync latency is bounded by the slowest conflicting
        # witness, not the sum of all of them.
        to_remove = []
        if conflicting:
            # return_exceptions: one examination blowing up on a
            # non-verification failure (device/backend error) must not
            # leave sibling examinations running unawaited — the failed
            # witness is simply left in place (we couldn't judge it)
            exams = await asyncio.gather(
                *(
                    self._examine_conflict(primary_trace, res, i, now)
                    for i, res in conflicting
                ),
                return_exceptions=True,
            )
            for (i, _res), ev in zip(conflicting, exams):
                if isinstance(ev, BaseException):
                    self.logger.error(
                        "witness conflict examination failed",
                        witness=self.witnesses[i].id(),
                        err=repr(ev),
                    )
                    continue
                if ev is not None:
                    raise ErrLightClientAttack(ev)
                to_remove.append(i)
        for i in sorted(to_remove, reverse=True):
            self.logger.info(
                "removing misbehaving witness", witness=self.witnesses[i].id()
            )
            del self.witnesses[i]
        if not header_matched:
            raise LightClientError(
                "failed to cross-reference header with any witness"
            )

    async def _examine_conflict(
        self,
        primary_trace: list[LightBlock],
        witness_block: LightBlock,
        witness_index: int,
        now: int,
    ) -> Optional[LightClientAttackEvidence]:
        """Walk the trace to find the bifurcation point; verify the
        witness's conflicting block from the last common trusted block
        (reference examineConflictingHeaderAgainstTrace :290). Returns
        evidence if the witness's chain verifies (a REAL fork)."""
        witness = self.witnesses[witness_index]
        common: Optional[LightBlock] = None
        diverged: Optional[LightBlock] = None  # primary's first forked block
        # early-stopping walk: the trace is bisection-short (O(log H))
        # and an RPC provider serializes calls on one connection anyway,
        # so eager whole-trace prefetch would only add round trips past
        # the divergence point. Cross-witness concurrency lives one
        # level up (_detect_divergence gathers the examinations).
        for lb in primary_trace:
            try:
                w = await witness.light_block(lb.height)
            except Exception:
                return None  # can't judge: treated like a missing block
            if w is None:
                return None
            if w.header.hash() == lb.header.hash():
                common = lb
            else:
                diverged = lb
                break
        if common is None or diverged is None:
            return None
        try:
            await self._off_loop(
                verify_non_adjacent,
                common,
                witness_block,
                self.trusting_period_ns,
                now,
                max_clock_drift_ns=self.max_clock_drift_ns,
            )
        except (VerificationError, ValueError):
            return None  # witness chain does not verify -> bad witness
        # Real fork: both chains verify from `common`. The evidence carries
        # the PRIMARY's forked block — honest full nodes (on the witness's
        # chain) judge it conflicting against their own canonical header
        # (reference newLightClientAttackEvidence, detector.go:408, packages
        # the block that contradicts the receiver's chain).
        return LightClientAttackEvidence(
            conflicting_header=diverged.header.encode(),
            conflicting_commit=diverged.commit.encode(),
            conflicting_validators=diverged.validators.encode(),
            common_height=common.height,
            total_voting_power=common.validators.total_voting_power(),
            timestamp_ns=common.header.time_ns,
        )

    async def _compare_with_witnesses(self, lb: LightBlock) -> None:
        """First-header cross-check (reference :1131)."""
        if not self.witnesses:
            return
        results = await asyncio.gather(
            *(w.light_block(lb.height) for w in self.witnesses),
            return_exceptions=True,
        )
        for res in results:
            if isinstance(res, BaseException) or res is None:
                continue
            if res.header.hash() != lb.header.hash():
                raise LightClientError(
                    "witness disagrees with primary on the trust root"
                )

    # --- provider management (reference :990-1129) --------------------------

    async def _block_from_primary(self, height: int) -> LightBlock:
        lb = None
        try:
            lb = await self.primary.light_block(height)
        except Exception as e:
            self.logger.info("primary error", err=str(e))
        if lb is not None:
            lb.validate_basic(self.chain_id)
            return lb
        # Replace the primary from the witness set (reference :1046).
        # Witnesses that merely don't have the block are NOT removed — a
        # transient availability blip must not destroy the witness set the
        # fork detector depends on.
        for i, candidate in enumerate(self.witnesses):
            try:
                lb = await candidate.light_block(height)
            except Exception:
                lb = None
            if lb is not None:
                self.logger.info(
                    "replaced primary", new_primary=candidate.id()
                )
                old_primary = self.primary
                self.primary = candidate
                self.witnesses[i] = old_primary
                lb.validate_basic(self.chain_id)
                return lb
        raise ErrNoProviderBlock(
            f"no provider has block at height {height}"
        )
