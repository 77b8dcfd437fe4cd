"""Blocksync reactor — channel 0x40 fast sync with batched commit verify.

Reference: blocksync/reactor.go — messages BlockRequest/BlockResponse/
NoBlockResponse/StatusRequest/StatusResponse (:21-22); poolRoutine
:387-663: peek two blocks, verify `first` using `second.LastCommit` via
VerifyCommitLight (:553 — HERE the TPU batch kernel replaces the serial
per-signer loop), check batch hash + BLS data (:558-600), apply, and
switch to consensus (or sequencer mode post-upgrade, :461-485) once
caught up.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from ..l2node.l2node import BlsData
from ..libs import protoio as pio
from ..libs.log import Logger, nop_logger
from ..p2p.mconn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..p2p.transport import Peer
from ..state.execution import BlockExecutor
from ..state.state import State
from ..store.block_store import BlockStore
from ..types.block import Block
from ..types.block_id import BlockID
from .pool import BlockPool

BLOCKSYNC_CHANNEL = 0x40

_REQ = 1
_RESP = 2
_NO_BLOCK = 3
_STATUS_REQ = 4
_STATUS_RESP = 5


def _enc(kind: int, **fields) -> bytes:
    out = pio.field_varint(1, kind)
    if "height" in fields:
        out += pio.field_varint(2, fields["height"])
    if "block" in fields:
        out += pio.field_bytes(3, fields["block"])
    if "base" in fields:
        out += pio.field_varint(4, fields["base"] + 1)
    return out


class BlocksyncReactor(Reactor):
    def __init__(
        self,
        state: State,
        executor: BlockExecutor,
        block_store: BlockStore,
        l2_node,
        on_caught_up: Optional[Callable] = None,
        upgrade_height: int = 0,
        on_upgrade: Optional[Callable] = None,
        logger: Optional[Logger] = None,
        active: bool = True,
        qc_enabled: bool = False,
    ):
        super().__init__("blocksync")
        self.active = active
        # QC plane ([consensus] quorum_certificates): when on and the
        # chain carries QuorumCertificates, catchup verifies ONE
        # aggregate pairing per block (a whole window as one
        # random-linear-combination round) instead of N ed25519 sigs —
        # blocks without a QC (legacy proposers in a mixed net) fall
        # back to the batched commit path transparently
        self.qc_enabled = qc_enabled
        self.qc_verified_blocks = 0
        self.state = state
        self.executor = executor
        self.block_store = block_store
        self.l2 = l2_node
        self.on_caught_up = on_caught_up
        self.upgrade_height = upgrade_height
        self.on_upgrade = on_upgrade
        self.logger = logger or nop_logger()
        self.pool = BlockPool(
            start_height=max(state.last_block_height + 1, state.initial_height),
            send_request=self._send_block_request,
            on_peer_error=self._report_peer,
        )
        self._task: Optional[asyncio.Task] = None
        self.synced = asyncio.Event()
        self.blocks_applied = 0
        # windowed batch verify is suspended below this height after a
        # batch failure (the per-block path must get past it first)
        self._window_suspended_below = 0
        # adaptive batch width: shrinks toward the observed rotation-free
        # run length (validator updates invalidate window verdicts), grows
        # back on full-window success — a chain rotating every height
        # converges to ~per-block work instead of O(window^2) re-verifies
        self._window_limit = self.VERIFY_WINDOW
        # validator-set hashes whose big-tier tables were already warmed
        # (the ~30s fixed-window build must happen in
        # an executor thread at sync start / rotation, never inline in the
        # verify pipeline)
        self._warmed: set[bytes] = set()

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=BLOCKSYNC_CHANNEL, priority=5, send_queue_capacity=1000
            )
        ]

    async def on_start(self) -> None:
        if self.active:
            self.start_sync()

    def start_sync(self) -> None:
        """Launch the sync routine (node assembly defers this until
        persistent peers are configured; reference fast_sync mode gate)."""
        if self._task is None:
            self.active = True
            self.pool.metrics.syncing.set(1)
            self._kick_warm(self.state.validators)
            self._task = asyncio.get_running_loop().create_task(
                self._pool_routine()
            )

    def _kick_warm(self, vals) -> None:
        """Pre-build the big-tier verify tables for a validator set in an
        executor thread, off the sync pipeline (the fixed-window build is
        ~seconds-per-100-keys; hitting it inline stalls the first >=512
        batch). Deduplicated by set hash; re-kicked
        on every rotation observed during apply. A failed warm un-marks
        the set so a later kick retries instead of leaving the inline
        stall permanently re-armed."""
        h = vals.hash()
        if h in self._warmed:
            return
        self._warmed.add(h)
        from ..crypto.batch_verifier import warm_validator_sets_in_executor

        fut = warm_validator_sets_in_executor([vals], logger=self.logger)
        if fut is not None:
            fut.add_done_callback(
                lambda f: self._warmed.discard(h) if f.exception() else None
            )

    async def on_stop(self) -> None:
        if self._task:
            self._task.cancel()

    # --- wire -------------------------------------------------------------

    def _send_block_request(self, peer_id: str, height: int) -> bool:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            return False
        return peer.send(BLOCKSYNC_CHANNEL, _enc(_REQ, height=height))

    def _report_peer(self, peer_id: str, reason: str) -> None:
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            asyncio.get_running_loop().create_task(
                self.switch.stop_peer_for_error(peer, reason)
            )

    async def add_peer(self, peer: Peer) -> None:
        # announce our status; ask for theirs
        peer.send(
            BLOCKSYNC_CHANNEL,
            _enc(
                _STATUS_RESP,
                height=self.block_store.height,
                base=self.block_store.base,
            ),
        )
        peer.send(BLOCKSYNC_CHANNEL, _enc(_STATUS_REQ, height=0))

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        self.pool.remove_peer(peer.id)

    async def receive(self, channel_id: int, peer: Peer, msg: bytes) -> None:
        f = pio.decode_fields(msg)
        kind = f.get(1, [0])[0]
        height = f.get(2, [0])[0]
        if kind == _REQ:
            block = self.block_store.load_block(height)
            if block is not None:
                peer.send(
                    BLOCKSYNC_CHANNEL,
                    _enc(_RESP, height=height, block=block.encode()),
                )
            else:
                peer.send(BLOCKSYNC_CHANNEL, _enc(_NO_BLOCK, height=height))
        elif kind == _RESP:
            try:
                block = Block.decode(f[3][0])
            except (KeyError, ValueError, EOFError) as e:
                await self.switch.stop_peer_for_error(
                    peer, f"undecodable block: {e}"
                )
                return
            self.pool.add_block(peer.id, block, size=len(msg))
        elif kind == _NO_BLOCK:
            self.pool.no_block(peer.id, height)
        elif kind == _STATUS_REQ:
            peer.send(
                BLOCKSYNC_CHANNEL,
                _enc(
                    _STATUS_RESP,
                    height=self.block_store.height,
                    base=self.block_store.base,
                ),
            )
        elif kind == _STATUS_RESP:
            base = f.get(4, [1])[0] - 1
            self.pool.set_peer_range(peer.id, base, height)

    # --- the sync loop ----------------------------------------------------

    async def _pool_routine(self) -> None:
        """reference poolRoutine :387-663."""
        status_tick = 0.0
        try:
            while True:
                self.pool.make_requests()
                await self._process_ready_blocks()
                status_tick += 0.05
                if status_tick >= 5.0:
                    status_tick = 0.0
                    if self.switch:
                        self.switch.broadcast(
                            BLOCKSYNC_CHANNEL, _enc(_STATUS_REQ, height=0)
                        )
                if self.pool.is_caught_up() and self.pool.num_pending() == 0:
                    await self._switch_over()
                    return
                await asyncio.sleep(0.05)
        except asyncio.CancelledError:
            pass

    # max consecutive blocks whose commits verify as one device batch
    VERIFY_WINDOW = 64

    async def _process_ready_blocks(self) -> None:
        """Windowed verify-then-apply (SURVEY.md §3.4's ideal shape): the
        commits of up to VERIFY_WINDOW consecutive ready blocks verify as
        ONE batched device call (vs the reference's one-serial-loop-per-
        block at reactor.go:553), then blocks apply in order.

        Correctness under validator-set rotation: the batch verdicts are
        computed against the set at the window base, so a verdict is only
        honored while `state.validators` still hashes the same — the
        moment an applied block rotates the set, the remaining verdicts
        are discarded and those heights re-verify (windowed again if the
        window path isn't suspended). A batch failure suspends the
        windowed path until the per-block fallback advances past the
        failing height, avoiding O(window) redundant batches.
        """
        while True:
            window = (
                self.pool.peek_window(
                    min(self.VERIFY_WINDOW, self._window_limit)
                )
                if self.pool.height >= self._window_suspended_below
                else []
            )
            if len(window) > 1:
                base_vals = self.state.validators
                base_hash = base_vals.hash()
                prepared = []
                entries = []
                qc_entries = []
                for first, commit, qc in window:
                    parts = first.make_part_set()
                    fid = BlockID(first.hash(), parts.header)
                    prepared.append((first, fid, parts, commit))
                    entries.append((fid, first.header.height, commit))
                    qc_entries.append((fid, first.header.height, qc))
                # device call off-loop: gossip/status handling stays live
                # while XLA runs (and while any table build holds the
                # big-tier lock). The classed dispatch routes the batch
                # through the process verify scheduler (blocksync
                # priority: consensus votes preempt, and this window
                # coalesces with light/evidence work into shared rounds)
                from ..parallel.scheduler import default_dispatch

                use_qc = (
                    self.qc_enabled
                    and base_vals.qc_capable()
                    and all(qc is not None for _, _, qc in qc_entries)
                )
                verdicts = None
                if use_qc:
                    # one qc_verify engine round for the whole window:
                    # a single RLC multi-pairing — verify cost flat in
                    # committee size (the QC plane's reason to exist)
                    verdicts = await (
                        asyncio.get_running_loop().run_in_executor(
                            None,
                            lambda: base_vals.verify_commits_qc(
                                self.state.chain_id, qc_entries
                            ),
                        )
                    )
                    if all(verdicts):
                        self.qc_verified_blocks += len(verdicts)
                    else:
                        # a hash-valid block with a bad aggregate: the
                        # full commit is authoritative (a mixed-mode
                        # committee may not have crypto-checked the
                        # proposer's QC) — re-judge the window on the
                        # N-sig path instead of stalling/punishing on
                        # the compressed proof
                        verdicts = None
                if verdicts is None:
                    verdicts = await (
                        asyncio.get_running_loop().run_in_executor(
                            None,
                            lambda: base_vals.verify_commits_light(
                                self.state.chain_id,
                                entries,
                                verifier=default_dispatch("blocksync"),
                            ),
                        )
                    )
                n_ok = 0
                for v in verdicts:
                    if not v:
                        break
                    n_ok += 1
                if n_ok < len(window):
                    # per-block fallback re-judges the failing height (it
                    # may be a set-size/forged issue); don't re-batch until
                    # we are past it
                    self._window_suspended_below = (
                        window[n_ok][0].header.height + 1
                    )
                # apply the verified prefix; verdicts are only valid while
                # the validator set is unchanged from the window base
                applied = 0
                rotated = False
                for i in range(n_ok):
                    if self.state.validators.hash() != base_hash:
                        rotated = True
                        break  # rotation: re-verify the rest next pass
                    first, fid, parts, commit = prepared[i]
                    try:
                        bls_datas = self._check_batch_data(first, commit)
                    except ValueError as e:
                        self.logger.info(
                            "invalid batch data in blocksync",
                            height=first.header.height,
                            err=repr(e),
                        )
                        self.pool.redo_request(
                            first.header.height, repr(e)
                        )
                        return
                    await self._apply_synced_block(
                        first, fid, parts, commit, bls_datas
                    )
                    applied += 1
                if rotated:
                    # next window ~ the rotation-free run just observed
                    # (floor 2 keeps the windowed path probing cheaply)
                    self._window_limit = max(2, applied)
                elif applied == len(window):
                    self._window_limit = min(
                        self.VERIFY_WINDOW, self._window_limit * 2
                    )
                if n_ok == len(window) and n_ok > 0:
                    continue
            first, second = self.pool.peek_two_blocks()
            if first is None or second is None:
                return
            first_parts = first.make_part_set()
            first_id = BlockID(first.hash(), first_parts.header)
            try:
                # verify first via second's LastCommit — ONE batched device
                # verification instead of the serial loop
                # (reference reactor.go:553)
                if second.last_commit is None:
                    raise ValueError("second block has no last commit")
                vals = self.state.validators
                from ..parallel.scheduler import default_dispatch

                second_qc = getattr(second, "last_qc", None)
                qc_ok = False
                if (
                    self.qc_enabled
                    and second_qc is not None
                    and vals.qc_capable()
                ):
                    ok = await asyncio.get_running_loop().run_in_executor(
                        None,
                        lambda: vals.verify_commits_qc(
                            self.state.chain_id,
                            [(first_id, first.header.height, second_qc)],
                        ),
                    )
                    qc_ok = bool(ok and ok[0])
                    if qc_ok:
                        self.qc_verified_blocks += 1
                if not qc_ok:
                    # no QC / bad aggregate: the full commit decides
                    # (the sig path raises into the redo handler below)
                    await asyncio.get_running_loop().run_in_executor(
                        None,
                        lambda: vals.verify_commit_light(
                            self.state.chain_id,
                            first_id,
                            first.header.height,
                            second.last_commit,
                            verifier=default_dispatch("blocksync"),
                        ),
                    )
                bls_datas = self._check_batch_data(
                    first, second.last_commit
                )
            except ValueError as e:
                self.logger.info(
                    "invalid block in blocksync", height=first.header.height, err=repr(e)
                )
                self.pool.redo_request(first.header.height, repr(e))
                return
            await self._apply_synced_block(
                first, first_id, first_parts, second.last_commit, bls_datas
            )

    async def _apply_synced_block(
        self, first: Block, first_id: BlockID, first_parts, commit, bls_datas
    ) -> None:
        """Save + apply one verified block (upgrade handoff raises
        CancelledError out of the pool routine)."""
        self.block_store.save_block(first, first_parts, commit)
        # backfill priority: the revalidation's LastCommit device round
        # rides the blocksync class, never ahead of live vote rounds
        self.state = await self.executor.apply_block(
            self.state, first_id, first, bls_datas,
            verify_klass="blocksync",
        )
        # rotation: start building the incoming set's tables now, in the
        # background, so the vote/bulk paths never pay the build inline
        self._kick_warm(self.state.validators)
        self.blocks_applied += 1
        self.pool.metrics.blocks_applied.inc()
        self.pool.metrics.latest_block_height.set(first.header.height)
        self.pool.pop_request()
        if (
            self.upgrade_height
            and first.header.height >= self.upgrade_height
        ):
            # post-upgrade blocks are sequencer blocks; hand off
            await self._switch_over()
            raise asyncio.CancelledError

    def _check_batch_data(self, first: Block, commit) -> list[BlsData]:
        """Batch-hash + BLS checks against the commit that verifies
        `first` (reference reactor.go:558-600)."""
        if not first.header.batch_hash:
            return []
        expect = self.l2.batch_hash(first.data.l2_batch_header)
        if expect != first.header.batch_hash:
            raise ValueError("batch hash mismatch in synced block")
        bls_datas = []
        for i, cs in enumerate(commit.signatures):
            if cs.is_absent() or not cs.bls_signature:
                continue
            idx, val = self.state.validators.get_by_address(
                cs.validator_address
            )
            if val is None:
                continue
            ok = self.l2.verify_signature(
                val.pub_key.data, first.header.batch_hash, cs.bls_signature
            )
            if ok is False:
                # definitive cryptographic rejection: the peer relayed a
                # corrupt commit
                raise ValueError("invalid BLS signature in synced commit")
            if ok is None:
                # undecidable (BLS registry lag / L2 unreachable): the
                # block itself is already proven by the ed25519 commit —
                # drop only this L1-bound contribution, don't punish the
                # peer or stall sync (tri-state contract, l2node.py)
                continue
            bls_datas.append(
                BlsData(cs.validator_address, cs.bls_signature)
            )
        return bls_datas

    async def _switch_over(self) -> None:
        """SwitchToConsensus / sequencer handoff (reference :461-485)."""
        self.synced.set()
        self.pool.metrics.syncing.set(0)
        if (
            self.upgrade_height
            and self.state.last_block_height >= self.upgrade_height
        ):
            if self.on_upgrade is not None:
                res = self.on_upgrade(self.state)
                if asyncio.iscoroutine(res):
                    await res
            return
        if self.on_caught_up is not None:
            res = self.on_caught_up(self.state)
            if asyncio.iscoroutine(res):
                await res
