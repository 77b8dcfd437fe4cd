"""The consensus state machine — Tendermint BFT as a single async loop.

Reference: consensus/state.go (State :85-160, receiveRoutine :766-855,
enterNewRound :1035 → enterPropose :1119 → enterPrevote :1380 →
enterPrecommit :1532 → enterCommit :1694 → finalizeCommit :1785-1948,
addVote :2274-2519, signVote :2522). The single-goroutine event loop over
(peer msgs, internal msgs, timeouts) is preserved — it is already the
right shape for determinism (SURVEY.md §2.3) — as one asyncio task.

Morph deltas reproduced:
- no mempool: proposals pull txs from the L2 notifier
  (defaultDecideProposal :1192 → createProposalBlock :1267),
- batch points: decideBatchPoint :1318-1362 (CalculateCap → SealBatch →
  batch hash into the header), BLS dual-sign on batch-point precommits
  (signVote :2522-2572) and BLS verification inside addVote :2362-2379,
- upgrade switch: at UpgradeBlockHeight, finalizeCommit stops BFT and
  hands off to sequencer mode (state.go:1921-1938).

Vote verification: incoming votes carry signatures verified through the
BatchVerifier (host fast path for singles, TPU for batches — the
micro-batching tradeoff); VoteSet inserts with verified=True.
"""

from __future__ import annotations

import asyncio
import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..crypto.batch_verifier import BatchVerifier, SigItem, default_verifier
from ..l2node.l2node import BlockData, BlsData, L2Node
from ..libs import fail
from ..obs import default_tracer
from ..obs.tracer import set_height_hint
from ..libs.events import EventSwitch
from ..libs.log import Logger, nop_logger
from ..state.execution import BlockExecutor
from ..state.state import State
from ..store.block_store import BlockStore
from ..types.block import Block, Commit
from ..types.block_id import BlockID
from ..types.part_set import Part, PartSet
from ..types.proposal import Proposal
from ..types.vote import Vote, VoteType
from ..types.vote_set import ConflictingVoteError, VoteSet
from .batch import BatchCache, get_batch_start
from .height_vote_set import HeightVoteSet
from .messages import (
    BlockPartMessage,
    ProposalMessage,
    VoteBatchMessage,
    VoteMessage,
)
from .pacing import (
    STEP_PRECOMMIT,
    STEP_PREVOTE,
    STEP_PROPOSE,
    PacingController,
)
from .ticker import TimeoutInfo, TimeoutTicker
from .wal import WAL, NilWAL, WALMessage, end_height_record


class Step(enum.IntEnum):
    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


@dataclass
class ConsensusConfig:
    """Timeouts (reference config/config.go:826-877 ConsensusConfig).

    The timeout_* values are the STATIC schedule. With adaptive_timeouts
    on, a PacingController (consensus/pacing.py) learns the live
    arrival-tail distributions and drives round-0 schedules dynamically
    between `adaptive_min_factor * static` (floor of last resort) and
    the static value (hard ceiling); rounds > 0 always run the static
    per-round escalation."""

    timeout_propose: float = 3.0
    timeout_propose_delta: float = 0.5
    timeout_prevote: float = 1.0
    timeout_prevote_delta: float = 0.5
    timeout_precommit: float = 1.0
    timeout_precommit_delta: float = 0.5
    timeout_commit: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    # --- adaptive pacing (consensus/pacing.py PacingConfig) ---------------
    adaptive_timeouts: bool = False
    adaptive_tail_quantile: float = 0.99
    adaptive_safety_margin: float = 1.25
    adaptive_headroom: float = 0.002
    adaptive_min_factor: float = 0.05
    adaptive_window: int = 256
    adaptive_min_samples: int = 8
    adaptive_backoff_step: float = 0.5
    adaptive_recover_step: float = 0.1
    # --- quorum certificates (types/quorum_cert.py) -----------------------
    # BLS dual-sign every non-nil precommit over the canonical QC
    # message, aggregate at +2/3 into one certificate carried next to
    # the full commit, and verify LastCommits via ONE pairing check.
    # Requires a qc-capable validator set (every member has a BLS key).
    quorum_certificates: bool = False
    # --- QC-chained height pipelining (PERF_ANALYSIS §22) ------------------
    # Enter H+1's propose the moment H's precommit quorum closes instead
    # of waiting out the straggler window: the closed quorum (and, with
    # quorum_certificates on, the QC the commit chain aggregates from it
    # in the background) IS H+1's justification. Messages from peers
    # already one height ahead are held in a bounded buffer and re-fed on
    # our own height transition, and the end-height fsync rides the
    # background finalization task (ordering, not placement, is what the
    # replay invariant needs — see _finalize_commit).
    pipelined_heights: bool = False

    def propose(self, round_: int) -> float:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote(self, round_: int) -> float:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit(self, round_: int) -> float:
        return self.timeout_precommit + self.timeout_precommit_delta * round_

    @classmethod
    def test_config(cls) -> "ConsensusConfig":
        return cls(
            timeout_propose=0.4,
            timeout_propose_delta=0.1,
            timeout_prevote=0.2,
            timeout_prevote_delta=0.1,
            timeout_precommit=0.2,
            timeout_precommit_delta=0.1,
            timeout_commit=0.05,
            skip_timeout_commit=True,
        )


# which fired timeouts are pacing failure signals, and which controller
# each maps to (NEW_HEIGHT/NEW_ROUND fire on every healthy height)
_PACING_TIMEOUT_STEPS = {
    Step.PROPOSE: STEP_PROPOSE,
    Step.PREVOTE_WAIT: STEP_PREVOTE,
    Step.PRECOMMIT_WAIT: STEP_PRECOMMIT,
}


# event-switch event names (reactor fast path)
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_VOTE = "Vote"
EVENT_PROPOSAL_BLOCK_PART = "ProposalBlockPart"
EVENT_VALID_BLOCK = "ValidBlock"


@dataclass
class RoundState:
    """Snapshot of the current round (reference consensus/types/
    round_state.go) — what the reactor gossips from."""

    height: int = 0
    round: int = 0
    step: Step = Step.NEW_HEIGHT
    start_time_ns: int = 0
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    triggered_timeout_precommit: bool = False


class ConsensusState:
    """One instance per node. start() spawns the receive routine."""

    def __init__(
        self,
        config: ConsensusConfig,
        state: State,
        executor: BlockExecutor,
        block_store: BlockStore,
        l2_node: L2Node,
        notifier=None,
        priv_validator=None,
        event_bus=None,
        wal=None,
        verifier: Optional[BatchVerifier] = None,
        bls_signer: Optional[Callable[[bytes], bytes]] = None,
        upgrade_height: int = 0,
        on_upgrade: Optional[Callable] = None,
        evidence_pool=None,
        metrics=None,
        tracer=None,
        logger: Optional[Logger] = None,
        now_ns: Callable[[], int] = time.time_ns,
        commit_pipeline=None,
        pacing=None,
        health=None,
    ):
        self.config = config
        self.executor = executor
        self.block_store = block_store
        self.l2 = l2_node
        self.notifier = notifier
        self.priv_validator = priv_validator
        self.event_bus = event_bus
        self.wal = wal or NilWAL()
        # consensus/commit_pipeline.CommitPipeline, or None for the
        # serial finalize path (reference behavior)
        self.pipeline = commit_pipeline
        self.verifier = verifier or default_verifier()
        self.bls_signer = bls_signer
        self.upgrade_height = upgrade_height
        self.on_upgrade = on_upgrade
        self.evpool = evidence_pool
        self.metrics = metrics  # libs.metrics.ConsensusMetrics or None
        # is-None check: an empty Tracer is falsy (it has __len__)
        self.tracer = default_tracer() if tracer is None else tracer
        self.logger = logger or nop_logger()
        self.now_ns = now_ns
        # pipelined heights need a commit pipeline to overlap into; as
        # with pacing below, an explicit one wins (node assembly wires
        # it with the group WAL + write-behind store), otherwise
        # self-construct so in-proc harnesses get the overlap from
        # `pipelined_heights` alone
        if self.pipeline is None and config.pipelined_heights:
            from .commit_pipeline import CommitPipeline

            self.pipeline = CommitPipeline(
                metrics=self.metrics,
                tracer=self.tracer,
                logger=self.logger,
            )
        # adaptive pacing: an explicit controller wins (node assembly
        # injects one); otherwise self-construct from the config so the
        # in-proc harnesses get it from `adaptive_timeouts` alone
        if pacing is None and config.adaptive_timeouts:
            pacing = PacingController.from_config(
                config, metrics=self.metrics, tracer=self.tracer
            )
        self.pacing = pacing
        # obs/health.HealthMonitor (or None): fed round advances and
        # height commits like the pacing controller, plus per-vote
        # arrival lags via HeightVoteSet — the live health plane's
        # consensus push seam
        self.health = health
        self._last_commit_walltime = 0.0
        # (step_name, t0, height, round) of the step in progress — the
        # flight recorder's per-step seam: each _new_step closes the
        # previous step's span and opens the next
        self._cur_step: Optional[tuple[str, float, int, int]] = None
        # (height, round, t0) of the last PREVOTE entry — matched against
        # the polka's height/round so a round that skipped prevote (e.g.
        # +2/3 precommits for a future round) can't observe a stale delay
        self._prevote_started: Optional[tuple[int, int, float]] = None
        # (height, round, t0) of the last PROPOSE entry — the pacing
        # controller's proposal-complete sample anchors here (and only
        # when the complete proposal matches the same height/round)
        self._propose_entered: Optional[tuple[int, int, float]] = None
        # perf_counter of the previous height's precommit quorum close;
        # LastCommit stragglers feed the pacing commit sketch against it
        self._last_quorum_close_pc: Optional[float] = None
        # validator indices whose too-late straggler precommit already
        # fed the commit sketch this height (gossip re-delivers)
        self._late_stragglers_fed: set[int] = set()
        # pipelined heights: messages for rs.height + 1 arriving while
        # this node is still closing rs.height (peers enter H+1 on the
        # quorum close, which races our finalize) — held and re-fed
        # through _handle_msg on our own height transition; neither the
        # in-proc harness nor a quiet gossip link re-sends, so dropping
        # them (the non-pipelined behavior) would wedge the follower
        self._next_height_buf: list[tuple] = []
        # reentrancy guard: a drained message can finalize the height
        # and re-enter the drain from inside _finalize_commit
        self._draining_next_height = False
        # (height, task) of the QC assembly chained behind that height's
        # commit — the H+1 proposer awaits the chained result instead of
        # paying the aggregate + pairing check on its propose path
        self._qc_chain: Optional[tuple[int, asyncio.Task]] = None

        self.event_switch = EventSwitch()

        self.state: State = state  # committed state (height = last block)
        # last height whose apply_block + state save fully completed;
        # with the pipeline, self.state may be one height ahead
        # (provisional) of this while a finalization task is in flight
        self._applied_height = state.last_block_height
        self.rs = RoundState()
        self._privval_pubkey = None

        self.peer_msg_queue: asyncio.Queue = asyncio.Queue(1000)
        self.internal_msg_queue: asyncio.Queue = asyncio.Queue(1000)
        self.ticker = TimeoutTicker()
        if self.pacing is not None:
            # raw-expiry tally (staleness-unfiltered; the back-off
            # decision itself sits behind _handle_timeout's filter)
            self.ticker.set_on_fire(self._on_ticker_fired)
        self._receive_task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()
        self._running = False
        self._decided_batch: Optional[tuple[bytes, bytes]] = None  # hash, header
        # L2 batch state across heights/restarts (reference consensus/batch.go)
        self.batch_cache = BatchCache()
        # height -> asyncio.Event fired after finalize (test hook)
        self._height_waiters: dict[int, asyncio.Event] = {}
        # called with each self-produced message (proposal/part/vote); the
        # reactor uses the event switch instead — this hook is the in-proc
        # harness's stand-in for gossip (reconstructing the deleted
        # consensus/common_test.go net, SURVEY.md §4.1)
        self.broadcast_hook: Optional[Callable] = None

    @property
    def is_running(self) -> bool:
        return self._running

    # --- lifecycle --------------------------------------------------------

    async def start(self, skip_wal_catchup: bool = False) -> None:
        """skip_wal_catchup: set when entering from blocksync/statesync —
        those paths advance state PAST the WAL's last end-height barrier,
        so the in-flight-message replay is both impossible and unneeded
        (the reference's SwitchToConsensus(state, skipWAL=true),
        consensus/state.go). An end-height record for the synced height is
        written instead so the next plain restart replays cleanly."""
        if self.priv_validator is not None:
            pk = self.priv_validator.get_pub_key()
            if asyncio.iscoroutine(pk):
                pk = await pk
            self._privval_pubkey = pk
        self._update_to_state(self.state)
        # crash recovery: re-feed in-flight WAL messages before going live
        # (reference catchupReplay, consensus/replay.go:95-173)
        if skip_wal_catchup:
            if not isinstance(self.wal, NilWAL):
                self.wal.write_end_height(self.state.last_block_height)
        elif not isinstance(self.wal, NilWAL):
            from .replay import catchup_replay

            n = await catchup_replay(self, self.wal)
            if n:
                self.logger.info("replayed WAL messages", count=n)
                if self.pacing is not None:
                    # replayed votes arrived at replay speed — their
                    # near-zero lags are not the live committee's tail
                    self.pacing.reset_learning()
        # warm-start the pacing tails persisted next to the WAL — after
        # the replay reset, so the pre-restart live tails win over both
        # the empty sketches and any replay contamination
        if self.pacing is not None and self.pacing.load_tails():
            self.logger.info(
                "pacing tails restored", path=self.pacing.persist_path
            )
        self._running = True
        self._receive_task = asyncio.get_running_loop().create_task(
            self._receive_routine(), name="consensus/receive"
        )
        self._schedule_round_0()

    async def stop(self) -> None:
        self._running = False
        self.ticker.stop()
        if self.pacing is not None:
            # persist the learned tails (no-op without a persist_path)
            # so the next start warm-starts instead of re-learning
            self.pacing.save_tails()
        if self._qc_chain is not None:
            # an unconsumed chained QC assembly (we stopped before
            # proposing the next height) must not outlive the loop
            _, task = self._qc_chain
            self._qc_chain = None
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        if self._receive_task:
            self._receive_task.cancel()
            try:
                await self._receive_task
            except (asyncio.CancelledError, Exception):
                pass
        if self.pipeline is not None:
            # in-flight apply completes (state save is part of it), then
            # queued block saves drain before the final WAL sync
            await self.pipeline.drain()
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.block_store.wait_durable
                )
            except Exception as e:
                # a latched write-behind failure must not abort the stop
                # sequence — it is already logged/latched for operators
                self.logger.error(
                    "block store drain failed at stop", err=repr(e)
                )
        try:
            self.wal.flush_and_sync()
        except Exception as e:
            # same rationale: a latched WAL fsync failure is already
            # fatal for liveness; stop must still tear down cleanly
            self.logger.error("WAL sync failed at stop", err=repr(e))
        self._stopped.set()

    async def wait_for_height(self, height: int, timeout: float = 30.0) -> None:
        """Test/RPC hook: block until `height` is committed AND applied."""
        if self._applied_height >= height:
            return
        ev = self._height_waiters.setdefault(height, asyncio.Event())
        await asyncio.wait_for(ev.wait(), timeout)

    # --- external input ---------------------------------------------------

    async def add_proposal(self, proposal: Proposal, peer_id: str = "") -> None:
        await self.peer_msg_queue.put((ProposalMessage(proposal), peer_id))

    async def add_block_part(
        self, height: int, round_: int, part: Part, peer_id: str = ""
    ) -> None:
        await self.peer_msg_queue.put(
            (BlockPartMessage(height, round_, part), peer_id)
        )

    async def add_vote(self, vote: Vote, peer_id: str = "") -> None:
        await self.peer_msg_queue.put((VoteMessage(vote), peer_id))

    # --- the event loop ---------------------------------------------------

    async def _receive_routine(self) -> None:
        """The single serialization point (reference receiveRoutine :766):
        every message is WAL-logged before it is processed."""
        while self._running:
            peer_get = asyncio.ensure_future(self.peer_msg_queue.get())
            internal_get = asyncio.ensure_future(self.internal_msg_queue.get())
            tock_get = asyncio.ensure_future(self.ticker.tock_queue.get())
            done, pending = await asyncio.wait(
                [peer_get, internal_get, tock_get],
                return_when=asyncio.FIRST_COMPLETED,
            )
            for p in pending:
                p.cancel()
            # each branch gets its own failure isolation: a bad peer
            # message must not swallow an already-dequeued timeout or our
            # own internal message
            if internal_get in done:
                batch = [internal_get.result()]
                try:
                    if self.pipeline is not None:
                        # group commit at the consumer: drain every
                        # already-queued internal message (a proposer
                        # enqueues proposal + all parts at once), WAL-
                        # write them all, and share ONE durability
                        # barrier — awaited, so the loop keeps serving
                        # the background finalization task while the
                        # flush thread syncs
                        while True:
                            try:
                                batch.append(
                                    self.internal_msg_queue.get_nowait()
                                )
                            except asyncio.QueueEmpty:
                                break
                        for m, _ in batch:
                            self._wal_write(m, sync=False)
                        await self.wal.abarrier()
                    else:
                        self._wal_write(batch[0][0], sync=True)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    # WAL write/fsync failure: the messages are NOT
                    # durably logged, so they must not be acted on
                    # (replay couldn't reproduce the transition — the
                    # log-before-process invariant is the double-sign
                    # guard). Drop the batch, keep the routine alive.
                    self.logger.error(
                        "internal msg WAL write failed; dropping",
                        n=len(batch),
                        err=repr(e),
                    )
                    batch = []
                for msg, peer_id in batch:
                    try:
                        await self._handle_msg(msg, peer_id)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        self.logger.error("internal msg failed", err=repr(e))
            if peer_get in done:
                msg, peer_id = peer_get.result()
                try:
                    self._wal_write(msg, sync=False)
                    await self._handle_msg(msg, peer_id)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self.logger.error(
                        "peer msg failed", peer=peer_id, err=repr(e)
                    )
            if tock_get in done:
                ti = tock_get.result()
                try:
                    self.wal.write(WALMessage("timeout", _encode_timeout(ti)))
                    await self._handle_timeout(ti)
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    self.logger.error("timeout handling failed", err=repr(e))

    def _wal_write(self, msg, sync: bool) -> None:
        try:
            kind, data = _encode_wal_msg(msg)
        except Exception:
            return
        if sync:
            self.wal.write_sync(WALMessage(kind, data))
        else:
            self.wal.write(WALMessage(kind, data))

    # hard cap on the next-height holding buffer: a full height of
    # committee traffic is far below this, and a byzantine flood of
    # future-height messages must not grow memory without bound
    _NEXT_HEIGHT_BUF_CAP = 4096

    def _buffer_next_height_msg(self, msg, peer_id: str) -> None:
        if len(self._next_height_buf) >= self._NEXT_HEIGHT_BUF_CAP:
            self.logger.error(
                "next-height buffer full; dropping",
                kind=type(msg).__name__,
                peer=peer_id,
            )
            return
        self._next_height_buf.append((msg, peer_id))

    async def _drain_next_height_buf(self) -> None:
        """Re-feed held H+1 messages once rs.height reaches them. A
        drained message can itself close the new height's quorum and
        finalize (re-entering here from _finalize_commit with the
        following height's messages re-stashed): the guard collapses the
        recursion and the outer loop picks the re-stash up."""
        if self._draining_next_height or not self._next_height_buf:
            return
        self._draining_next_height = True
        try:
            progressed = True
            while progressed and self._next_height_buf:
                progressed = False
                pending = self._next_height_buf
                self._next_height_buf = []
                for msg, peer_id in pending:
                    h = _msg_height(msg)
                    if h is not None and h < self.rs.height:
                        continue  # already decided; gossip catchup serves it
                    if h is not None and h > self.rs.height:
                        self._buffer_next_height_msg(msg, peer_id)
                        continue
                    progressed = True
                    try:
                        await self._handle_msg(msg, peer_id)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        self.logger.error(
                            "buffered next-height msg failed", err=repr(e)
                        )
        finally:
            self._draining_next_height = False

    async def _handle_msg(self, msg, peer_id: str) -> None:
        if self.config.pipelined_heights:
            h = _msg_height(msg)
            if h is not None and h == self.rs.height + 1:
                self._buffer_next_height_msg(msg, peer_id)
                return
        if isinstance(msg, ProposalMessage):
            self._set_proposal(msg.proposal)
        elif isinstance(msg, BlockPartMessage):
            added = self._add_proposal_block_part(msg)
            if added:
                await self._handle_complete_proposal(msg.height)
        elif isinstance(msg, VoteMessage):
            await self._try_add_vote(
                msg.vote,
                peer_id,
                pre_verified=msg.pre_verified,
                bls_pre_verified=msg.bls_pre_verified,
            )
        elif isinstance(msg, VoteBatchMessage):
            # a committee-sized chunk enters the vote sets as one unit:
            # one WAL record, one queue put, one pass over the votes —
            # per-vote semantics (conflict capture, quorum transitions)
            # identical to N single VoteMessages in the same order
            for vote, pre, bls in msg.iter_flags():
                await self._try_add_vote(
                    vote, peer_id, pre_verified=pre, bls_pre_verified=bls
                )
        else:
            self.logger.error("unknown msg type", msg=type(msg).__name__)

    def _on_ticker_fired(self, ti: TimeoutInfo) -> None:
        step = _PACING_TIMEOUT_STEPS.get(ti.step)
        if step is not None and self.pacing is not None:
            self.pacing.on_ticker_fired(step)

    async def _handle_timeout(self, ti: TimeoutInfo) -> None:
        rs = self.rs
        if (
            ti.height != rs.height
            or ti.round < rs.round
            or (ti.round == rs.round and ti.step < rs.step)
        ):
            return  # stale
        if self.pacing is not None:
            # a non-stale fired step timeout means the learned schedule
            # did not cover the committee this round: AIMD back-off
            step = _PACING_TIMEOUT_STEPS.get(ti.step)
            if step is not None:
                self.pacing.on_timeout_fired(step)
        if ti.step == Step.NEW_HEIGHT:
            await self._enter_new_round(ti.height, 0)
        elif ti.step == Step.NEW_ROUND:
            await self._enter_propose(ti.height, 0)
        elif ti.step == Step.PROPOSE:
            await self._enter_prevote(ti.height, ti.round)
        elif ti.step == Step.PREVOTE_WAIT:
            await self._enter_precommit(ti.height, ti.round)
        elif ti.step == Step.PRECOMMIT_WAIT:
            await self._enter_precommit(ti.height, ti.round)
            await self._enter_new_round(ti.height, ti.round + 1)

    # --- round transitions ------------------------------------------------

    def _schedule_round_0(self) -> None:
        sleep = max(
            0.0, (self.rs.start_time_ns - self.now_ns()) / 1e9
        )
        self.ticker.schedule(
            TimeoutInfo(sleep, self.rs.height, 0, Step.NEW_HEIGHT)
        )

    def _schedule_timeout(
        self, duration_s: float, height: int, round_: int, step: Step
    ) -> None:
        self.ticker.schedule(TimeoutInfo(duration_s, height, round_, step))

    def _new_step(self) -> None:
        # close the previous step's span (its duration is only known at
        # the transition) and open the next; one histogram observation
        # per recorded span, so the exported count equals the number of
        # step transitions the trace shows
        rs = self.rs
        now = time.perf_counter()
        prev = self._cur_step
        if prev is not None:
            name, t0, h, r = prev
            if self.metrics is not None:
                self.metrics.step_duration.observe(now - t0, step=name)
            self.tracer.add_span(
                f"cs.{name}", t0, now - t0, height=h, round=r
            )
        name = rs.step.name.lower()
        self._cur_step = (name, now, rs.height, rs.round)
        # publish the height/round in progress for seams that submit
        # work on this node's behalf without seeing a height (the
        # remote verify client stamps it into wire trace context)
        set_height_hint(rs.height, rs.round)
        if name == "prevote":
            self._prevote_started = (rs.height, rs.round, now)
        self.event_switch.fire_event(EVENT_NEW_ROUND_STEP, self.rs)

    async def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if height != rs.height or round_ < rs.round or (
            round_ == rs.round and rs.step != Step.NEW_HEIGHT
        ):
            return
        if round_ > rs.round:
            # round catchup: increment proposer priority view
            pass
        if round_ > 0:
            if self.metrics is not None:
                self.metrics.rounds.inc()
            self.tracer.event(
                "cs.round_advance", height=height, round=round_
            )
            if self.pacing is not None:
                self.pacing.on_round_advance(round_)
            if self.health is not None:
                self.health.observe_round_advance(height, round_)
        if self.metrics is not None:
            self.metrics.round_gauge.set(round_)
        rs.round = round_
        rs.step = Step.NEW_ROUND
        if round_ > 0:
            # new round wipes the proposal (unless re-proposing valid block)
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_)
        rs.triggered_timeout_precommit = False
        self._new_step()
        if self.event_bus is not None:
            await self.event_bus.publish_new_round(
                (height, round_, self._proposer_address(round_))
            )
        await self._enter_propose(height, round_)

    def _proposer_for_round(self, round_: int):
        vals = self.state.validators
        if round_ == 0:
            return vals.get_proposer()
        return vals.copy_increment_proposer_priority(round_).get_proposer()

    def _proposer_address(self, round_: int) -> bytes:
        return self._proposer_for_round(round_).address

    def _is_proposer(self, round_: int) -> bool:
        return (
            self._privval_pubkey is not None
            and self._proposer_address(round_) == self._privval_pubkey.address()
        )

    async def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PROPOSE
        ):
            return
        rs.step = Step.PROPOSE
        self._new_step()
        self._propose_entered = (height, round_, time.perf_counter())
        dur = (
            self.pacing.propose(round_)
            if self.pacing is not None
            else self.config.propose(round_)
        )
        self._schedule_timeout(dur, height, round_, Step.PROPOSE)
        if self._is_proposer(round_):
            await self._decide_proposal(height, round_)
        # if we already have a complete proposal (e.g. from a peer or a
        # valid block), move on immediately
        if self._is_proposal_complete():
            await self._enter_prevote(height, round_)

    async def _ensure_applied(self) -> None:
        """App-hash-future barrier: callers that consume apply results
        (proposal header construction, header validation, the next
        finalize) wait here for the in-flight background finalization;
        everything else runs on the provisional state. No-op on the
        serial path and once the future resolved."""
        if self.pipeline is not None:
            await self.pipeline.wait_applied()

    async def _decide_proposal(self, height: int, round_: int) -> None:
        """defaultDecideProposal (reference :1192): build or re-propose."""
        # the proposal header carries app_hash / last_results_hash /
        # next_validators_hash from the previous height's apply
        await self._ensure_applied()
        rs = self.rs
        if rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            t0 = time.perf_counter()
            block, parts = await self._create_proposal_block(height)
            dur = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.proposal_create_seconds.observe(dur)
            self.tracer.add_span(
                "cs.proposal_create", t0, dur, height=height, round=round_
            )
            if block is None:
                return
        bid = BlockID(block.hash(), parts.header)
        proposal = Proposal(
            height=height,
            round=round_,
            pol_round=rs.valid_round,
            block_id=bid,
            timestamp_ns=self.now_ns(),
        )
        try:
            res = self.priv_validator.sign_proposal(
                self.state.chain_id, proposal
            )
            if asyncio.iscoroutine(res):
                await res
        except Exception as e:
            self.logger.error("failed to sign proposal", err=repr(e))
            return
        await self.internal_msg_queue.put((ProposalMessage(proposal), ""))
        if self.broadcast_hook is not None:
            self.broadcast_hook(ProposalMessage(proposal))
        for i in range(parts.total):
            part_msg = BlockPartMessage(height, round_, parts.get_part(i))
            await self.internal_msg_queue.put((part_msg, ""))
            if self.broadcast_hook is not None:
                self.broadcast_hook(part_msg)

    async def _create_proposal_block(
        self, height: int
    ) -> tuple[Optional[Block], Optional[PartSet]]:
        """createProposalBlock + decideBatchPoint (reference :1267, :1318)."""
        if self.notifier is not None:
            block_data = self.notifier.get_block_data(height)
        else:
            block_data = self.l2.request_block_data(height)
        last_commit = None
        if height > self.state.initial_height:
            if (
                self.rs.last_commit is not None
                and self.rs.last_commit.has_two_thirds_majority()
            ):
                last_commit = self.rs.last_commit.make_commit()
            else:
                last_commit = self.block_store.load_seen_commit(height - 1)
                if last_commit is None:
                    self.logger.error("no last commit; cannot propose")
                    return None, None
        block_time = max(self.now_ns(), self.state.last_block_time_ns + 1)
        block = self.executor.create_proposal_block(
            height,
            self.state,
            last_commit,
            self._privval_pubkey.address(),
            block_data,
            block_time,
        )
        # QC plane: compress last_commit into a QuorumCertificate and
        # carry it next to the full commit — assembled on demand from
        # the retained CommitSigs (one aggregate + one verify per
        # height, on the proposer only, OFF the event loop: the
        # pairing check is milliseconds the vote/timeout plane must
        # not stall on). None (a legacy-signed commit, sub-quorum QC
        # signatures) just ships the full commit alone.
        if (
            self.config.quorum_certificates
            and last_commit is not None
            and self.state.last_validators.qc_capable()
        ):
            # pipelined heights hand the proposer an already-assembled
            # certificate (chained behind H-1's commit, _maybe_chain_qc);
            # the on-demand path below is the fallback for round > 0
            # re-proposals, restarts, and non-pipelined configs
            qc = await self._take_chained_qc(height - 1)
            if qc is None:
                from ..types.quorum_cert import assemble_qc

                qc = await (
                    asyncio.get_running_loop().run_in_executor(
                        None,
                        assemble_qc,
                        self.state.chain_id,
                        last_commit,
                        self.state.last_validators,
                    )
                )
            block.last_qc = qc
        # decideBatchPoint (reference :1318-1362): seal when the L2 says
        # size is exceeded OR the on-chain Batch params' blocks_interval /
        # timeout elapsed since the batch start (which survives restarts
        # via the block-store walk in get_batch_start, batch.go:67-99).
        self._decided_batch = None
        start_h, start_t = get_batch_start(
            self.batch_cache,
            block.header.height,
            self.state.initial_height,
            self.state.last_block_time_ns,
            self.block_store,
        )
        bp = self.state.consensus_params.batch
        size_exceeded = self.l2.calculate_batch_size_with_proposal_block(
            block.encode(), False
        )
        seal = block.header.height != 1 and (
            size_exceeded
            or (
                bp.blocks_interval > 0
                and block.header.height - start_h >= bp.blocks_interval
            )
            or (
                bp.timeout_ns > 0
                and block.header.time_ns - start_t >= bp.timeout_ns
            )
        )
        if seal:
            batch_hash, batch_header = self.l2.seal_batch()
            block.set_batch_point(batch_hash, batch_header)
            self._decided_batch = (batch_hash, batch_header)
            self.batch_cache.store_batch_data(
                block.hash(), batch_hash, batch_header
            )
        parts = block.make_part_set()
        return block, parts

    def _is_proposal_complete(self) -> bool:
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        pv = rs.votes.prevotes(rs.proposal.pol_round)
        return pv is not None and pv.has_two_thirds_majority()

    # --- proposal / parts -------------------------------------------------

    def _set_proposal(self, proposal: Proposal) -> None:
        """defaultSetProposal: verify the proposer's signature."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or (
            0 <= proposal.pol_round >= proposal.round
        ):
            raise ValueError("invalid proposal POL round")
        proposer = self._proposer_for_round(rs.round)
        if not proposer.pub_key.verify(
            proposal.sign_bytes(self.state.chain_id), proposal.signature
        ):
            raise ValueError("invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.part_set_header)

    def _add_proposal_block_part(self, msg: BlockPartMessage) -> bool:
        rs = self.rs
        if msg.height != rs.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        if rs.proposal_block is not None:
            return False  # already complete
        try:
            added = rs.proposal_block_parts.add_part(msg.part)
        except ValueError:
            raise
        if added and self.metrics is not None:
            self.metrics.block_parts.inc()
        if added and rs.proposal_block_parts.is_complete():
            rs.proposal_block = Block.decode(
                rs.proposal_block_parts.get_bytes()
            )
            self.event_switch.fire_event(EVENT_PROPOSAL_BLOCK_PART, rs)
        return added

    async def _handle_complete_proposal(self, height: int) -> None:
        rs = self.rs
        if rs.proposal_block is None:
            return
        if self.pacing is not None:
            # proposal-complete delay sample: only when the propose-step
            # entry matches this height/round (parts that complete a
            # proposal before we entered PROPOSE carry no wait signal)
            # and we are not the proposer (our own proposal is local)
            pe = self._propose_entered
            if (
                pe is not None
                and pe[0] == height
                and pe[1] == rs.round
                and not self._is_proposer(rs.round)
            ):
                self.pacing.observe_proposal_complete(
                    time.perf_counter() - pe[2]
                )
        prevotes = rs.votes.prevotes(rs.round)
        bid, has_polka = (
            prevotes.two_thirds_majority() if prevotes else (None, False)
        )
        if has_polka and not bid.is_zero() and rs.valid_round < rs.round:
            if rs.proposal_block.hash() == bid.hash:
                rs.valid_round = rs.round
                rs.valid_block = rs.proposal_block
                rs.valid_block_parts = rs.proposal_block_parts
        if rs.step <= Step.PROPOSE and self._is_proposal_complete():
            await self._enter_prevote(height, rs.round)
            if has_polka:
                await self._enter_precommit(height, rs.round)
        elif rs.step == Step.COMMIT:
            await self._try_finalize_commit(height)

    # --- prevote ----------------------------------------------------------

    async def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PREVOTE
        ):
            return
        rs.step = Step.PREVOTE
        self._new_step()
        await self._do_prevote(height, round_)

    async def _do_prevote(self, height: int, round_: int) -> None:
        """defaultDoPrevote (reference :1406): locked block > valid
        proposal > nil."""
        # header validation below checks app_hash/last_results_hash —
        # apply results of the previous height
        await self._ensure_applied()
        rs = self.rs
        if rs.locked_block is not None:
            await self._sign_add_vote(
                VoteType.PREVOTE,
                rs.locked_block.hash(),
                rs.locked_block_parts.header,
            )
            return
        if rs.proposal_block is None:
            await self._sign_add_vote(VoteType.PREVOTE, b"", None)
            return
        # pin the proposal across the off-loop validation await: the
        # loop keeps running (that is the point — the commit-light
        # dispatch no longer stalls it), so rs may move meanwhile
        block = rs.proposal_block
        try:
            await self.executor.validate_block_off_loop(self.state, block)
            if (
                rs.height != height
                or rs.round != round_
                or rs.proposal_block is not block
            ):
                # moved on while validating (round/height advanced, or
                # a concurrent step swapped/cleared the proposal): the
                # new step decides — only the pinned `block` below
                return
            ok = self.executor.process_proposal(self.state, block)
            if not ok:
                raise ValueError("CheckBlockData rejected proposal")
            # batch-point consistency: a batch hash in the header must match
            # what the L2 node computes from the carried batch header
            bh = block.header.batch_hash
            if bh:
                expect = self.l2.batch_hash(
                    block.data.l2_batch_header
                )
                if expect != bh:
                    raise ValueError("batch hash mismatch in proposal")
                # decideBatchPointWithProposedBlock (reference :1365-1377):
                # a non-proposer seals its OWN L2 batch at the proposed
                # point and requires the locally-derived hash to equal the
                # header's — otherwise the proposer and this node disagree
                # about L2 batch contents and the proposal is invalid.
                # (The proposer already sealed in _create_proposal_block
                # and stored the batch data under its block hash.)
                if self.batch_cache.batch_data(block.hash()) is None:
                    self.l2.calculate_batch_size_with_proposal_block(
                        block.encode(), True
                    )
                    local_hash, local_header = self.l2.seal_batch()
                    if local_hash != bh:
                        raise ValueError(
                            "locally sealed batch hash disagrees with proposal"
                        )
                    self.batch_cache.store_batch_data(
                        block.hash(), local_hash, local_header
                    )
        except ValueError as e:
            if (
                rs.height != height
                or rs.round != round_
                or rs.proposal_block is not block
            ):
                # the state moved during the off-loop validation await
                # (e.g. this height committed): the failure is against
                # a state the proposal was never meant for — don't sign
                # anything for the round we're no longer in
                return
            self.logger.info("prevoting nil: invalid proposal", err=repr(e))
            await self._sign_add_vote(VoteType.PREVOTE, b"", None)
            return
        await self._sign_add_vote(
            VoteType.PREVOTE,
            block.hash(),
            rs.proposal_block_parts.header,
        )

    async def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PREVOTE_WAIT
        ):
            return
        rs.step = Step.PREVOTE_WAIT
        self._new_step()
        dur = (
            self.pacing.prevote(round_)
            if self.pacing is not None
            else self.config.prevote(round_)
        )
        self._schedule_timeout(dur, height, round_, Step.PREVOTE_WAIT)

    # --- precommit --------------------------------------------------------

    async def _enter_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PRECOMMIT
        ):
            return
        rs.step = Step.PRECOMMIT
        self._new_step()
        # the lock branch validates the proposal block against state
        await self._ensure_applied()
        prevotes = rs.votes.prevotes(round_)
        bid, ok = (
            prevotes.two_thirds_majority() if prevotes else (None, False)
        )
        ps = self._prevote_started
        if (
            ok
            and self.metrics is not None
            and ps is not None
            and ps[:2] == (height, round_)
        ):
            self.metrics.quorum_prevote_delay.observe(
                time.perf_counter() - ps[2]
            )
        if not ok:
            # no polka: precommit nil
            await self._sign_add_vote(VoteType.PRECOMMIT, b"", None)
            return
        if bid.is_zero():
            # polka for nil: unlock (reference :1625-1643)
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            if self.event_bus is not None:
                await self.event_bus.publish_unlock(rs)
            await self._sign_add_vote(VoteType.PRECOMMIT, b"", None)
            return
        # polka for a block
        if rs.locked_block is not None and rs.locked_block.hash() == bid.hash:
            # relock
            rs.locked_round = round_
            if self.event_bus is not None:
                await self.event_bus.publish_relock(rs)
            await self._sign_add_vote(
                VoteType.PRECOMMIT, bid.hash, bid.part_set_header
            )
            return
        if (
            rs.proposal_block is not None
            and rs.proposal_block.hash() == bid.hash
        ):
            block = rs.proposal_block
            try:
                await self.executor.validate_block_off_loop(
                    self.state, block
                )
            except ValueError as e:
                if rs.height != height or rs.round != round_ or (
                    rs.step > Step.PRECOMMIT
                ) or rs.proposal_block is not block:
                    # stale: the state advanced mid-await (e.g. the
                    # height committed), so the block legitimately no
                    # longer validates against it — not a +2/3-on-
                    # invalid fault
                    return
                raise RuntimeError(
                    f"+2/3 prevoted an invalid block: {e}"
                ) from e
            if rs.height != height or rs.round != round_ or (
                rs.step > Step.PRECOMMIT
            ) or rs.proposal_block is not block:
                return  # moved on while the off-loop validation ran
            rs.locked_round = round_
            rs.locked_block = block
            rs.locked_block_parts = rs.proposal_block_parts
            if self.event_bus is not None:
                await self.event_bus.publish_lock(rs)
            await self._sign_add_vote(
                VoteType.PRECOMMIT, bid.hash, bid.part_set_header
            )
            return
        # polka for a block we don't have: unlock, fetch it, precommit nil
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or not rs.proposal_block_parts.has_header(
            bid.part_set_header
        ):
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet(bid.part_set_header)
        if self.event_bus is not None:
            await self.event_bus.publish_unlock(rs)
        await self._sign_add_vote(VoteType.PRECOMMIT, b"", None)

    async def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ != rs.round or (
            rs.triggered_timeout_precommit
        ):
            return
        rs.triggered_timeout_precommit = True
        self._new_step()
        dur = (
            self.pacing.precommit(round_)
            if self.pacing is not None
            else self.config.precommit(round_)
        )
        self._schedule_timeout(dur, height, round_, Step.PRECOMMIT_WAIT)

    # --- commit -----------------------------------------------------------

    async def _enter_commit(self, height: int, commit_round: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step >= Step.COMMIT:
            return
        rs.step = Step.COMMIT
        rs.commit_round = commit_round
        self._new_step()
        precommits = rs.votes.precommits(commit_round)
        bid, ok = precommits.two_thirds_majority()
        if not ok or bid.is_zero():
            raise RuntimeError("enterCommit without +2/3 block precommits")
        # if we locked the block, it is the proposal block
        if rs.locked_block is not None and rs.locked_block.hash() == bid.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if (
            rs.proposal_block is None
            or rs.proposal_block.hash() != bid.hash
        ):
            if rs.proposal_block_parts is None or not (
                rs.proposal_block_parts.has_header(bid.part_set_header)
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(bid.part_set_header)
                self.event_switch.fire_event(EVENT_VALID_BLOCK, rs)
        await self._try_finalize_commit(height)

    async def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height:
            return
        precommits = rs.votes.precommits(rs.commit_round)
        bid, ok = precommits.two_thirds_majority()
        if not ok or bid.is_zero():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != bid.hash:
            return  # waiting for the block parts
        await self._finalize_commit(height)

    async def _finalize_commit(self, height: int) -> None:
        """finalizeCommit (reference :1785-1948).

        Serial path: save block → WAL end-height fsync → apply → state
        save, all before entering H+1 (reference behavior). Pipelined
        path (commit_pipeline): block save is enqueued on the
        write-behind store, the WAL end-height barrier is awaited on the
        group-commit flush thread, and apply + state save run as a
        background finalization task — the state machine enters H+1 on
        a provisional state immediately after the WAL barrier."""
        rs = self.rs
        precommits = rs.votes.precommits(rs.commit_round)
        bid, _ = precommits.two_thirds_majority()
        block, parts = rs.proposal_block, rs.proposal_block_parts

        block.validate_basic()
        # the previous height's apply must have landed before this
        # height's state copy / batch bookkeeping below
        await self._ensure_applied()
        fail.fail_point()
        t_commit = time.perf_counter()
        # save block + seen commit (enqueue-only on the write-behind store)
        seen_commit = None
        if self.block_store.height < height:
            seen_commit = precommits.make_commit()
            with self.tracer.span(
                "store.save_block", height=height, round=rs.round
            ):
                t_save = time.perf_counter()
                self.block_store.save_block(block, parts, seen_commit)
                if self.metrics is not None and self.pipeline is None:
                    # pipelined saves report from the store worker
                    self.metrics.block_store_save_seconds.observe(
                        time.perf_counter() - t_save
                    )
        fail.fail_point()
        # WAL barrier: after this record, the height is decided.
        # Pipelined heights move the WAIT for the fsync off the decision
        # path onto the background finalization task (before anything
        # durable happens there): what replay needs is the ORDER — state
        # may only advance to H after end_height(H) is durable, and our
        # own H+1 messages are only acted on after the receive routine's
        # batch barrier, which (group commit preserves file order)
        # covers this record too. The fsync itself overlaps H+1's
        # propose instead of serializing ahead of it.
        wal_mark: Optional[int] = None
        pipelining = (
            self.config.pipelined_heights and self.pipeline is not None
        )
        if self.pipeline is not None:
            self.wal.write(end_height_record(height))
            if pipelining:
                wal_mark = self.wal.mark()
            else:
                await self.wal.abarrier()
        else:
            self.wal.write_end_height(height)
        fail.fail_point()

        # collect BLS contributions for batch points (morph)
        bls_datas = []
        if block.header.batch_hash:
            candidates = [
                v
                for v in precommits.votes
                if v is not None and v.bls_signature
            ]
            # Commit-time gate: a batch-point precommit that arrived BEFORE
            # this node knew the proposal bypassed the ingestion-time BLS
            # check (the batch hash was unknown); an unverified garbage
            # signature must not reach commit_batch and poison the
            # L1-bound aggregate. One batched check (2 pairings all-valid)
            # keeps only contributions the L2 vouches for.
            verdicts = self._verify_bls_datas(
                block.header.batch_hash, candidates
            )
            for v, ok in zip(candidates, verdicts):
                if ok:
                    bls_datas.append(
                        BlsData(
                            signer=v.validator_address,
                            signature=v.bls_signature,
                        )
                    )
                else:
                    self.logger.error(
                        "dropping invalid BLS contribution at commit",
                        validator=v.validator_address.hex()[:12],
                    )

        upgrading = bool(
            self.upgrade_height and height >= self.upgrade_height
        )
        base_state = self.state
        if self.pipeline is not None and not upgrading:
            # batch cache rollover (reference state.go:1902-1910) — needs
            # only the block, so it stays on the decision path.
            # Pipelined commit_seconds = the finalize CRITICAL PATH
            # (save enqueue + WAL barrier); apply cost is attributed by
            # the exec.apply_block span and pipeline_wait.
            self.batch_cache.on_block_committed(block)
            self._record_committed(t_commit, block, parts, pipelined=True)
            barrier = None
            if wal_mark is not None:
                # the end-height fsync the decision path stopped waiting
                # for: the background task waits instead, BEFORE apply
                # persists anything (state save outrunning this barrier
                # would leave a crash image whose state has no WAL
                # end-height record — the fatal replay case). The fsync
                # overlaps H+1's propose instead of serializing ahead
                # of it.
                mark = wal_mark

                async def _wal_boundary(mark=mark, h=height):
                    with self.tracer.span(
                        "wal.pipeline_barrier", height=h
                    ):
                        await self.wal.abarrier_to(mark)

                barrier = _wal_boundary
            self.pipeline.begin(
                height,
                lambda: self._apply_committed(
                    height, bid, block, base_state, bls_datas
                ),
                barrier=barrier,
            )
            self._update_to_state(
                self._provisional_state(base_state, bid, block),
                provisional=True,
            )
            self._maybe_chain_qc(height, seen_commit, base_state)
            self._schedule_round_0()
            await self._drain_next_height_buf()
            return

        state_copy = base_state.copy()
        with self.tracer.span(
            "exec.apply_block", height=height, round=rs.round
        ):
            new_state = await self.executor.apply_block(
                state_copy, bid, block, bls_datas
            )
        fail.fail_point()
        # batch cache rollover (reference state.go:1902-1910)
        self.batch_cache.on_block_committed(block)
        self._record_committed(t_commit, block, parts, pipelined=False)

        # upgrade switch (reference state.go:1921-1938 + upgrade/upgrade.go)
        if upgrading:
            self.logger.info("upgrade height reached; stopping BFT", height=height)
            self._running = False
            self.state = new_state
            self._applied_height = height
            if self.on_upgrade is not None:
                res = self.on_upgrade(new_state)
                if asyncio.iscoroutine(res):
                    await res
            self._notify_height(height)
            return

        self._update_to_state(new_state)
        self._notify_height(height)
        self._maybe_chain_qc(height, seen_commit, base_state)
        self._schedule_round_0()
        await self._drain_next_height_buf()

    def _record_committed(
        self, t_commit: float, block, parts, pipelined: bool
    ) -> None:
        """Commit telemetry, identical for both finalize paths (only the
        commit_seconds SCOPE differs: serial = full finalize, pipelined
        = the critical path up to this call)."""
        if self.pacing is not None:
            self.pacing.on_height_committed(
                block.header.height, self.rs.round
            )
        if self.health is not None:
            self.health.observe_height_committed(
                block.header.height, self.rs.round
            )
        if self.metrics is not None:
            self.metrics.commit_seconds.observe(
                time.perf_counter() - t_commit
            )
            self.metrics.total_txs.inc(len(block.data.txs))
            # the part set already knows the encoded size — never
            # re-encode the block on the commit path just to measure it
            self.metrics.block_size_bytes.observe(parts.byte_size)
        self.logger.info(
            "committed block (apply pipelined)"
            if pipelined
            else "committed block",
            height=block.header.height,
            round=self.rs.round,
            txs=len(block.data.txs),
            batch_point=bool(block.header.batch_hash),
        )

    def _provisional_state(self, state: State, bid: BlockID, block) -> State:
        """The pre-apply view of the next height's State: everything
        consensus needs to run H+1's rounds is already determined —
        validators(H+1) = next_validators(H) — while apply-derived
        fields (app_hash, last_results_hash, next_validators updates,
        consensus-params updates) keep the previous height's values and
        are only read behind the `_ensure_applied` barrier."""
        next_validators = state.next_validators.copy()
        next_validators.increment_proposer_priority(1)
        return State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=block.header.height,
            last_block_id=bid,
            last_block_time_ns=block.header.time_ns,
            validators=state.next_validators.copy(),
            next_validators=next_validators,
            last_validators=state.validators.copy(),
            last_height_validators_changed=state.last_height_validators_changed,
            consensus_params=state.consensus_params,
            last_height_consensus_params_changed=(
                state.last_height_consensus_params_changed
            ),
            last_results_hash=state.last_results_hash,
            app_hash=state.app_hash,
        )

    def _maybe_chain_qc(self, height: int, seen_commit, base_state) -> None:
        """Chain `height`'s QC assembly behind its commit: when WE
        propose the next height, start the aggregate + pairing check in
        the executor NOW, so by propose time the certificate is (almost
        always) already sitting in the chain instead of being assembled
        on the propose critical path. Called after _update_to_state, so
        self.state.validators is already the NEXT height's set and
        _is_proposer answers for it; `base_state` still holds the set
        that signed `seen_commit`."""
        if (
            not self.config.pipelined_heights
            or not self.config.quorum_certificates
            or seen_commit is None
            or not self._is_proposer(0)
            or not base_state.validators.qc_capable()
        ):
            return
        from ..types.quorum_cert import assemble_qc

        loop = asyncio.get_running_loop()
        chain_id = base_state.chain_id
        val_set = base_state.validators
        t0 = time.perf_counter()

        async def _assemble():
            qc = await loop.run_in_executor(
                None, assemble_qc, chain_id, seen_commit, val_set
            )
            self.tracer.add_span(
                "commit.qc_assemble",
                t0,
                time.perf_counter() - t0,
                height=height,
            )
            return qc

        prev = self._qc_chain
        if prev is not None and not prev[1].done():
            prev[1].cancel()
        self._qc_chain = (height, loop.create_task(_assemble()))

    async def _take_chained_qc(self, height: int):
        """The QC the commit chain assembled for `height`, or None (not
        chained / failed / chained for another height) — the caller
        falls back to on-demand assembly. Awaits an in-flight chain: it
        started at commit time, so by propose time it is typically
        already done."""
        chain, self._qc_chain = self._qc_chain, None
        if chain is None:
            return None
        h, task = chain
        if h != height:
            task.cancel()
            return None
        try:
            return await task
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.logger.error("chained qc assembly failed", err=repr(e))
            return None

    async def _apply_committed(
        self, height: int, bid: BlockID, block, base_state: State, bls_datas
    ) -> State:
        """The background finalization task body: ABCI/L2 apply + state
        save, then swap the provisional state for the applied one BEFORE
        the app-hash future resolves, so every awaiter observes the full
        state. With pipelined heights the pipeline chains this behind
        the end-height durability barrier (CommitPipeline.begin)."""
        state_copy = base_state.copy()
        with self.tracer.span("exec.apply_block", height=height):
            new_state = await self.executor.apply_block(
                state_copy, bid, block, bls_datas
            )
        fail.fail_point()
        if self.rs.height == height + 1:
            # still on the next height (always true: the next finalize
            # sits behind _ensure_applied) — adopt apply-derived fields
            self.state = new_state
        self._applied_height = height
        self._notify_height(height)
        return new_state

    def _notify_height(self, height: int) -> None:
        ev = self._height_waiters.pop(height, None)
        if ev is not None:
            ev.set()
        for h in list(self._height_waiters):
            if h <= height:
                self._height_waiters.pop(h).set()

    def _update_to_state(self, state: State, provisional: bool = False) -> None:
        """updateToState (reference :622): reset RoundState for the next
        height. `provisional` marks the pipelined entry into H+1 before
        apply completes — identical except that the applied-height
        watermark (and wait_for_height) advances only when the
        background finalization swaps in the real state."""
        if not provisional:
            self._applied_height = max(
                self._applied_height, state.last_block_height
            )
        if self.metrics is not None:
            self.metrics.height.set(state.last_block_height)
            if state.validators is not None:
                self.metrics.validators.set(state.validators.size())
            now = time.monotonic()
            if self._last_commit_walltime and state.last_block_height:
                self.metrics.block_interval.observe(
                    now - self._last_commit_walltime
                )
            self._last_commit_walltime = now
        rs = self.rs
        last_precommits = None
        if rs.commit_round > -1 and rs.votes is not None:
            pc = rs.votes.precommits(rs.commit_round)
            if pc is not None and pc.has_two_thirds_majority():
                last_precommits = pc
            # carry the commit round's quorum-close instant across the
            # height transition: precommits that arrive AFTER this point
            # land in LastCommit (the HVS below is fresh) but are still
            # exactly the stragglers timeout_commit waits for
            self._last_quorum_close_pc = rs.votes.quorum_closed_at(
                rs.commit_round, VoteType.PRECOMMIT
            )
            self._late_stragglers_fed.clear()
        height = (
            state.initial_height
            if state.last_block_height == 0
            else state.last_block_height + 1
        )
        self.state = state
        rs.height = height
        rs.round = 0
        rs.step = Step.NEW_HEIGHT
        # commit_time + timeout_commit (reference: wait for stragglers).
        # Adaptive pacing replaces the static straggler window with the
        # learned post-quorum arrival tail (clamped to the static value
        # as ceiling) — the dominant term of wall-per-height once the
        # commit pipeline moved compute off the critical path (§12/§14)
        base = self.now_ns()
        commit_wait = self.config.timeout_commit
        if self.pacing is not None and state.last_block_height > 0:
            commit_wait = self.pacing.commit_wait()
        rs.start_time_ns = base + int(commit_wait * 1e9)
        if (
            self.config.skip_timeout_commit
            or self.config.pipelined_heights
        ) and last_precommits is not None:
            # pipelined heights: the closed quorum is the justification —
            # enter H+1 NOW. Stragglers past this point miss LastCommit
            # (they still feed the pacing sketch via the late-straggler
            # path); the commit stays valid at +2/3, and with the QC
            # plane on the certificate carries the same quorum compressed.
            rs.start_time_ns = self.now_ns()
        rs.proposal = None
        rs.proposal_block = None
        rs.proposal_block_parts = None
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        rs.valid_round = -1
        rs.valid_block = None
        rs.valid_block_parts = None
        rs.votes = HeightVoteSet(
            state.chain_id,
            height,
            state.validators,
            tracer=self.tracer,
            metrics=self.metrics,
            pacing=self.pacing,
            health=self.health,
        )
        rs.commit_round = -1
        rs.last_commit = last_precommits
        rs.triggered_timeout_precommit = False
        if self.notifier is not None:
            self.notifier.enable_for_height(height)
        self._new_step()

    # --- votes ------------------------------------------------------------

    async def _try_add_vote(
        self,
        vote: Vote,
        peer_id: str,
        pre_verified: bool = False,
        bls_pre_verified: bool = False,
    ) -> bool:
        try:
            return await self._add_vote(
                vote, peer_id, pre_verified, bls_pre_verified
            )
        except ConflictingVoteError as e:
            # equivocation: report to the pool, which resolves the
            # validator against the HISTORICAL set at the vote's height and
            # stamps the committed block's time on the next Update
            # (reference ReportConflictingVotes, evidence/pool.go:179 +
            # processConsensusBuffer :459). No current-set gate here: an
            # H-1 straggler equivocation from a just-removed validator is
            # still valid evidence.
            if self.evpool is not None:
                self.evpool.report_conflicting_votes(e.existing, e.new)
            self.logger.info(
                "conflicting vote captured",
                validator=vote.validator_address.hex()[:12],
            )
            return False
        except ValueError as e:
            self.logger.info("bad vote", err=repr(e))
            return False

    async def _add_vote(
        self,
        vote: Vote,
        peer_id: str,
        pre_verified: bool = False,
        bls_pre_verified: bool = False,
    ) -> bool:
        """addVote (reference :2274-2519). `pre_verified` votes already
        passed the reactor's device micro-batcher; skip the serial check."""
        rs = self.rs
        # precommit from the previous height (straggler for LastCommit)
        if (
            vote.height + 1 == rs.height
            and vote.type == VoteType.PRECOMMIT
            and rs.step == Step.NEW_HEIGHT
            and rs.last_commit is not None
        ):
            added = rs.last_commit.add_vote(
                vote,
                verified=pre_verified
                or self._verify_vote(vote, self.state.last_validators),
            )
            if (
                added
                and self.pacing is not None
                and self._last_quorum_close_pc is not None
            ):
                self.pacing.observe_post_quorum_straggler(
                    VoteType.PRECOMMIT,
                    time.perf_counter() - self._last_quorum_close_pc,
                )
            return added
        if vote.height != rs.height:
            # previous-height precommits that arrive too late even for
            # the LastCommit window are STILL commit-tail samples: the
            # controller's output (the commit wait) must not censor its
            # own input stream, or a tightened wait could never observe
            # the widened tail of a degrading validator and would
            # exclude it from LastCommit forever. Verified only — an
            # unverifiable straggler must not inflate the learned wait.
            if (
                self.pacing is not None
                and self._last_quorum_close_pc is not None
                and vote.height + 1 == rs.height
                and vote.type == VoteType.PRECOMMIT
                # once per validator per height: gossip re-delivers, and
                # a duplicate of a vote LastCommit already holds is not
                # a missed straggler
                and vote.validator_index not in self._late_stragglers_fed
                and not (
                    rs.last_commit is not None
                    and 0 <= vote.validator_index < len(rs.last_commit.votes)
                    and rs.last_commit.votes[vote.validator_index]
                    is not None
                )
                and (
                    pre_verified
                    or self._verify_vote(vote, self.state.last_validators)
                )
            ):
                self._late_stragglers_fed.add(vote.validator_index)
                lag = time.perf_counter() - self._last_quorum_close_pc
                self.pacing.observe_post_quorum_straggler(
                    VoteType.PRECOMMIT, lag
                )
                self.tracer.event(
                    "pacing.straggler_missed",
                    height=vote.height,
                    val=vote.validator_index,
                    lag_ms=round(lag * 1e3, 3),
                )
            return False

        if not pre_verified and not self._verify_vote(
            vote, self.state.validators
        ):
            raise ValueError("invalid vote signature")

        # morph: BLS dual-signature on batch-point precommits
        # (reference :2297-2312, :2362-2379)
        if (
            vote.type == VoteType.PRECOMMIT
            and not vote.is_nil()
            and self._batch_hash_for_block(vote.block_id.hash)
        ):
            batch_hash = self._batch_hash_for_block(vote.block_id.hash)
            _, val = self.state.validators.get_by_address(
                vote.validator_address
            )
            if not vote.bls_signature:
                raise ValueError("missing BLS signature at batch point")
            if not bls_pre_verified and not self.l2.verify_signature(
                val.pub_key.data, batch_hash, vote.bls_signature
            ):
                raise ValueError("invalid BLS signature on batch hash")
            self.l2.append_bls_data(
                vote.height,
                batch_hash,
                BlsData(vote.validator_address, vote.bls_signature),
            )

        added = rs.votes.add_vote(vote, peer_id, verified=True)
        if not added:
            return False
        self.event_switch.fire_event(EVENT_VOTE, vote)
        if self.event_bus is not None:
            await self.event_bus.publish_vote(vote)

        if vote.type == VoteType.PREVOTE:
            await self._on_prevote_added(vote)
        else:
            await self._on_precommit_added(vote)
        return added

    def _batch_hash_for_block(self, block_hash: bytes) -> bytes:
        """The batch hash if block_hash is a known batch-point proposal
        (the per-proposal cache first — reference
        decideBatchPointWithProposedBlock :1365-1377)."""
        bd = self.batch_cache.batch_data(block_hash)
        if bd is not None and bd.batch_hash:
            return bd.batch_hash
        rs = self.rs
        for blk in (rs.proposal_block, rs.locked_block, rs.valid_block):
            if blk is not None and blk.hash() == block_hash:
                return blk.header.batch_hash
        return b""

    def _verify_bls_datas(self, batch_hash: bytes, votes: list) -> list:
        """Per-vote verdicts for the commit's BLS contributions via the
        L2's batched port (falls back to serial verify_signature)."""
        if not votes:
            return []
        pubkeys = []
        for v in votes:
            _, val = self.state.validators.get_by_address(
                v.validator_address
            )
            pubkeys.append(val.pub_key.data if val is not None else b"")
        sigs = [v.bls_signature for v in votes]
        batch_fn = getattr(self.l2, "verify_signatures", None)
        if batch_fn is not None:
            return list(batch_fn(pubkeys, batch_hash, sigs))
        return [
            self.l2.verify_signature(pk, batch_hash, s)
            for pk, s in zip(pubkeys, sigs)
        ]

    def batch_hash_for_vote(self, vote: Vote) -> bytes:
        """The batch hash a current-height batch-point precommit's BLS
        signature must cover, or b"" (reactor BLS micro-batcher hook)."""
        if (
            vote.type != VoteType.PRECOMMIT
            or vote.is_nil()
            or vote.height != self.rs.height
        ):
            return b""
        return self._batch_hash_for_block(vote.block_id.hash)

    def pubkey_for_vote(self, vote: Vote):
        """Resolve the signer pubkey for a vote (reactor micro-batcher
        pre-verification). None if the index/address don't match the
        validator set for the vote's height."""
        if vote.height + 1 == self.rs.height:
            vals = self.state.last_validators
        elif vote.height == self.rs.height:
            vals = self.state.validators
        elif (
            vote.height == self.rs.height + 1
            and self.config.pipelined_heights
        ):
            # pipelined peers run one height ahead while our finalize
            # drains; their H+1 votes are buffered, but pre-verify them
            # against the set the state transition already determined
            # (validators(H+1) = next_validators) so the micro-batcher
            # amortizes them too
            vals = self.state.next_validators
        else:
            return None
        if vals is None:
            return None
        val = vals.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            return None
        return val.pub_key

    def _verify_vote(self, vote: Vote, vals) -> bool:
        """Signature check through the batch verifier (host fast path for
        singles; the reactor pre-batches under load)."""
        val = vals.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            return False
        if self.metrics is not None:
            self.metrics.votes_verified.inc(path="inline")
        ok = self.verifier.verify(
            [
                SigItem(
                    val.pub_key.data,
                    vote.sign_bytes(self.state.chain_id),
                    vote.signature,
                    key_type=getattr(val.pub_key, "type_name", "ed25519"),
                )
            ]
        )
        return bool(ok[0])

    async def _on_prevote_added(self, vote: Vote) -> None:
        """Prevote threshold logic (reference :2398-2476)."""
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round)
        bid, ok = prevotes.two_thirds_majority()
        if ok:
            # unlock on a later polka (reference: "Unlock if prevotes
            # justify it")
            if (
                rs.locked_block is not None
                and rs.locked_round < vote.round <= rs.round
                and rs.locked_block.hash() != bid.hash
            ):
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
                if self.event_bus is not None:
                    await self.event_bus.publish_unlock(rs)
            # update valid block on polka for the proposal block
            if (
                not bid.is_zero()
                and rs.valid_round < vote.round == rs.round
            ):
                if (
                    rs.proposal_block is not None
                    and rs.proposal_block.hash() == bid.hash
                ):
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                elif rs.proposal_block_parts is None or not (
                    rs.proposal_block_parts.has_header(bid.part_set_header)
                ):
                    # polka for a block we don't have: start fetching it
                    rs.proposal_block = None
                    rs.proposal_block_parts = PartSet(bid.part_set_header)
                self.event_switch.fire_event(EVENT_VALID_BLOCK, rs)
                if self.event_bus is not None:
                    await self.event_bus.publish_polka(rs)

        if rs.round < vote.round and prevotes.has_two_thirds_any():
            await self._enter_new_round(rs.height, vote.round)
        elif rs.round == vote.round and rs.step >= Step.PREVOTE:
            if ok and (self._is_proposal_complete() or bid.is_zero()):
                await self._enter_precommit(rs.height, vote.round)
            elif prevotes.has_two_thirds_any():
                await self._enter_prevote_wait(rs.height, vote.round)
        elif (
            rs.proposal is not None
            and 0 <= rs.proposal.pol_round == vote.round
        ):
            if self._is_proposal_complete():
                await self._enter_prevote(rs.height, rs.round)

    async def _on_precommit_added(self, vote: Vote) -> None:
        """Precommit threshold logic (reference :2478-2516)."""
        rs = self.rs
        precommits = rs.votes.precommits(vote.round)
        bid, ok = precommits.two_thirds_majority()
        if ok:
            await self._enter_new_round(rs.height, vote.round)
            await self._enter_precommit(rs.height, vote.round)
            if not bid.is_zero():
                await self._enter_commit(rs.height, vote.round)
                if self.config.skip_timeout_commit and precommits.has_all():
                    pass  # commit already finalizes; next height scheduled
            else:
                await self._enter_precommit_wait(rs.height, vote.round)
        elif rs.round <= vote.round and precommits.has_two_thirds_any():
            await self._enter_new_round(rs.height, vote.round)
            await self._enter_precommit_wait(rs.height, vote.round)

    # --- signing ----------------------------------------------------------

    async def _sign_add_vote(
        self, vote_type: int, block_hash: bytes, psh
    ) -> Optional[Vote]:
        """signVote + send to our own queue (reference signAddVote :2596)."""
        if self.priv_validator is None or self._privval_pubkey is None:
            return None
        addr = self._privval_pubkey.address()
        idx, _ = self.state.validators.get_by_address(addr)
        if idx < 0:
            return None  # not a validator this height
        rs = self.rs
        from ..types.part_set import PartSetHeader

        vote = Vote(
            type=vote_type,
            height=rs.height,
            round=rs.round,
            block_id=BlockID(
                block_hash, psh if psh is not None else PartSetHeader()
            ),
            timestamp_ns=self.now_ns(),
            validator_address=addr,
            validator_index=idx,
        )
        # morph: BLS dual-sign precommits on batch-point blocks
        # (reference signVote :2522-2572)
        if (
            vote_type == VoteType.PRECOMMIT
            and block_hash
            and self.bls_signer is not None
        ):
            batch_hash = self._batch_hash_for_block(block_hash)
            if batch_hash:
                vote.bls_signature = self.bls_signer(batch_hash)
            # QC plane: dual-sign EVERY non-nil precommit over the
            # canonical QC message (same BLS key, distinct domain) —
            # the contribution a +2/3 commit aggregates into one
            # QuorumCertificate
            if self.config.quorum_certificates:
                from ..types.quorum_cert import qc_sign_bytes

                vote.qc_signature = self.bls_signer(
                    qc_sign_bytes(
                        self.state.chain_id,
                        rs.height,
                        rs.round,
                        vote.block_id,
                    )
                )
        try:
            res = self.priv_validator.sign_vote(self.state.chain_id, vote)
            if asyncio.iscoroutine(res):
                await res
        except Exception as e:
            self.logger.error("failed to sign vote", err=repr(e))
            return None
        await self.internal_msg_queue.put((VoteMessage(vote), ""))
        if self.broadcast_hook is not None:
            self.broadcast_hook(VoteMessage(vote))
        return vote


def _msg_height(msg) -> Optional[int]:
    """The consensus height a queue message belongs to, or None for
    message kinds without one (the pipelined next-height buffer keys
    on this)."""
    if isinstance(msg, ProposalMessage):
        return msg.proposal.height
    if isinstance(msg, (BlockPartMessage, VoteBatchMessage)):
        return msg.height
    if isinstance(msg, VoteMessage):
        return msg.vote.height
    return None


# --- WAL codec for consensus messages -------------------------------------

from ..libs import protoio as pio


def _encode_wal_msg(msg) -> tuple[str, bytes]:
    from .messages import encode_msg

    return "consensus", encode_msg(msg)


def _encode_timeout(ti: TimeoutInfo) -> bytes:
    return (
        pio.field_varint(1, int(ti.duration_s * 1e9))
        + pio.field_varint(2, ti.height)
        + pio.field_varint(3, ti.round + 1)
        + pio.field_varint(4, int(ti.step))
    )
