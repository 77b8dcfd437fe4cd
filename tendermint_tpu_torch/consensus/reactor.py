"""Consensus reactor — gossips rounds, proposals, block parts, and votes.

Reference: consensus/reactor.go — 4 channels State(0x20)/Data(0x21)/
Vote(0x22)/VoteSetBits(0x23) (:28-31), per-peer `PeerState` HRS+bitarray
bookkeeping (:969-1260), and three pull-based gossip routines per peer:
gossipDataRoutine :531 (block parts + catchup :628), gossipVotesRoutine
:671, queryMaj23Routine :804. The shape is preserved: gossip is PULL —
routines compare our RoundState against the peer's claimed state and send
what the peer is missing; the broadcast hook pushes our own fresh
messages as an accelerator.
"""

from __future__ import annotations

import asyncio
import secrets
import time
from dataclasses import dataclass, field
from typing import Optional

from ..libs.bits import BitArray
from ..libs.log import Logger, nop_logger
from ..libs.metrics import bounded_label
from ..p2p.mconn import ChannelDescriptor
from ..p2p.switch import Reactor
from ..p2p.transport import Peer
from ..types.part_set import PartSet
from ..types.vote import VOTE_TYPE_NAMES, Vote, VoteType
from .messages import (
    BlockPartMessage,
    HasVoteMessage,
    HasVotesMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteBatchMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
    decode_msg,
    encode_msg,
)
from .state_machine import (
    EVENT_NEW_ROUND_STEP,
    EVENT_PROPOSAL_BLOCK_PART,
    EVENT_VALID_BLOCK,
    EVENT_VOTE,
    ConsensusState,
    Step,
)

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23
# committee-scale vote plane: peers that advertise this channel accept
# VoteBatchMessage chunks (all their missing votes for one vote set per
# gossip tick, in bounded chunks) — legacy peers keep getting one
# VoteMessage per tick on VOTE_CHANNEL
VOTE_BATCH_CHANNEL = 0x24

GOSSIP_SLEEP = 0.05
MAJ23_SLEEP = 2.0

# votes per VoteBatchMessage: bounds the wire message (~250 B/vote with
# a BLS dual-sign -> ~16 KB/chunk) and the receive side's one-dispatch
# pre-verification round; a 200-validator vote set ships in 4 chunks
VOTE_BATCH_MAX = 64
# defensive cap on an INCOMING batch (a peer ignoring VOTE_BATCH_MAX is
# bounded before any signature work)
VOTE_BATCH_MAX_ACCEPT = 1024
# commit-catchup votes reconstructed per gossip tick on the legacy
# single-vote path (the batch path ships VOTE_BATCH_MAX per tick): the
# old code returned after ONE vote, so catching a peer up an
# N-validator commit cost N ticks x GOSSIP_SLEEP
COMMIT_CATCHUP_BUDGET = 32
# batch-path chunk hygiene: a pass normally waits until at least this
# many votes are missing before shipping a chunk — a single fresh vote
# is usually in flight to the peer already (the origin's own broadcast
# push + other relays), and the peer's HasVote announcement dedupes it
# within ~1 gossip tick. After VOTE_BATCH_HOLDBACK_TICKS passes without
# a send, any non-empty chunk ships regardless, so a straggler vote is
# delayed at most ~HOLDBACK x GOSSIP_SLEEP, never withheld.
VOTE_BATCH_MIN_FILL = 4
VOTE_BATCH_HOLDBACK_TICKS = 2
# eager-forward fanout: a freshly-accepted chunk relays immediately to
# at most this many batch-capable peers (rotation-randomized). Relaying
# to EVERY neighbor multiplies each vote by the full edge count before
# possession digests can catch up — epidemic fanout 3 + the paced pull
# plane covers the committee with ~3x redundancy instead of ~degree x
VOTE_FORWARD_FANOUT = 3
# possession digests are dedupe hints, not latency-critical: broadcast
# them at a multiple of the gossip tick so a churning vote set doesn't
# turn the digest plane itself into a per-tick flood at committee scale
DIGEST_INTERVAL = 4 * GOSSIP_SLEEP


@dataclass
class PeerRoundState:
    """What we believe the peer's round state is
    (reference consensus/types/peer_round_state.go)."""

    height: int = 0
    round: int = -1
    step: int = 0
    proposal: bool = False
    proposal_block_psh = None
    proposal_block_parts: Optional[BitArray] = None
    proposal_pol_round: int = -1
    proposal_pol: Optional[BitArray] = None
    prevotes: dict[int, BitArray] = field(default_factory=dict)
    precommits: dict[int, BitArray] = field(default_factory=dict)
    last_commit_round: int = -1
    last_commit: Optional[BitArray] = None
    catchup_commit_round: int = -1
    catchup_commit: Optional[BitArray] = None

    def get_votes_bits(self, height: int, round_: int, vtype: int, size: int) -> BitArray:
        if height == self.height:
            table = self.prevotes if vtype == VoteType.PREVOTE else self.precommits
            if round_ not in table:
                table[round_] = BitArray(size)
            return table[round_]
        if height == self.height - 1 and vtype == VoteType.PRECOMMIT:
            if self.last_commit is None or self.last_commit.size != size:
                self.last_commit = BitArray(size)
            return self.last_commit
        return BitArray(size)

    def set_has_vote(self, height: int, round_: int, vtype: int, index: int, size: int) -> None:
        self.get_votes_bits(height, round_, vtype, size).set(index, True)

    def apply_new_round_step(self, msg: NewRoundStepMessage) -> None:
        if msg.height != self.height:
            self.proposal = False
            self.proposal_block_psh = None
            self.proposal_block_parts = None
            self.proposal_pol_round = -1
            self.proposal_pol = None
            self.prevotes = {}
            self.precommits = {}
            if msg.height == self.height + 1:
                # our precommits become their last commit
                self.last_commit_round = self.precommits and max(self.precommits) or -1
            self.last_commit_round = msg.last_commit_round
            self.last_commit = None
        elif msg.round != self.round:
            self.proposal = False
            self.proposal_block_psh = None
            self.proposal_block_parts = None
            self.proposal_pol_round = -1
            self.proposal_pol = None
        self.height = msg.height
        self.round = msg.round
        self.step = msg.step


class ConsensusReactor(Reactor):
    def __init__(
        self,
        cs: ConsensusState,
        vote_batcher=None,
        logger: Optional[Logger] = None,
        vote_batch: bool = True,
        vote_batch_max: int = VOTE_BATCH_MAX,
        digest_interval: float = DIGEST_INTERVAL,
        vote_forward_fanout: int = VOTE_FORWARD_FANOUT,
    ):
        super().__init__("consensus")
        self.cs = cs
        # gossip-pacing knobs ([consensus] digest_interval /
        # vote_forward_fanout): module constants stay the defaults, but
        # bench sweeps and deployments drive them from config
        self.digest_interval = float(digest_interval)
        self.vote_forward_fanout = max(0, int(vote_forward_fanout))
        # committee-scale batched vote gossip ([consensus]
        # vote_batch_gossip): when off, this node neither advertises
        # VOTE_BATCH_CHANNEL nor sends batches — the wire behavior of
        # the pre-batch reactor, kept for mixed-version interop tests
        self.vote_batch = bool(vote_batch)
        self.vote_batch_max = max(1, int(vote_batch_max))
        # gossip-efficiency telemetry (bench --family committee_scale):
        # a "tick" is one vote-gossip loop pass that shipped >= 1 vote;
        # the one-vote-per-tick baseline pins votes/tick at 1, batching
        # lifts it toward vote_batch_max
        self.gossip_ticks = 0
        self.gossip_idle_ticks = 0
        self.gossip_votes_sent = 0
        self.gossip_batches_sent = 0
        # device micro-batcher for incoming vote signatures; None falls
        # back to the state machine's serial verify
        if vote_batcher is None:
            from .vote_batcher import VoteBatcher

            vote_batcher = VoteBatcher(verifier=cs.verifier)
        self.vote_batcher = vote_batcher
        self.logger = logger or nop_logger()
        # causal gossip annotations (obs/cluster.py): every proposal/
        # block-part/vote send+receive is an event tagged with enough
        # identity (height, round, type, index, peer) that a receive on
        # node B joins the matching send on node A in a merged timeline
        self.tracer = cs.tracer
        # aggregate micro-batcher for batch-point BLS signatures: a
        # round's burst verifies as 2 pairings instead of 2 per vote
        from .bls_batcher import BLSBatcher

        self.bls_batcher = BLSBatcher(cs.l2, logger=self.logger)
        self._peer_states: dict[str, PeerRoundState] = {}
        self._peer_tasks: dict[str, list[asyncio.Task]] = {}
        self._digest_task: Optional[asyncio.Task] = None
        # fast-path: push our own messages + round steps
        cs.event_switch.add_listener(
            "reactor", EVENT_NEW_ROUND_STEP, self._on_new_round_step
        )
        cs.event_switch.add_listener("reactor", EVENT_VOTE, self._on_vote)
        cs.event_switch.add_listener(
            "reactor", EVENT_VALID_BLOCK, self._on_valid_block
        )
        cs.broadcast_hook = self._broadcast_own

    def get_channels(self) -> list[ChannelDescriptor]:
        chans = [
            ChannelDescriptor(id=STATE_CHANNEL, priority=6),
            ChannelDescriptor(id=DATA_CHANNEL, priority=10),
            ChannelDescriptor(id=VOTE_CHANNEL, priority=7),
            ChannelDescriptor(id=VOTE_SET_BITS_CHANNEL, priority=1),
        ]
        if self.vote_batch:
            # advertised in NodeInfo.channels, which is how peers learn
            # we accept batches (sending 0x24 to a peer that does not
            # advertise it would kill the connection: mconn treats an
            # unknown channel as a protocol error)
            chans.append(
                ChannelDescriptor(id=VOTE_BATCH_CHANNEL, priority=7)
            )
        return chans

    def _peer_supports_batch(self, peer: Peer) -> bool:
        if not self.vote_batch:
            return False
        info = getattr(peer, "node_info", None)
        return info is not None and VOTE_BATCH_CHANNEL in (
            info.channels or b""
        )

    # --- event-switch fast path ------------------------------------------

    def _on_new_round_step(self, rs) -> None:
        if self.switch is not None:
            self.switch.broadcast(
                STATE_CHANNEL, encode_msg(self._new_round_step_msg())
            )

    def _on_vote(self, vote: Vote) -> None:
        # announce possession so peers stop sending it to us. Legacy
        # peers get the per-vote HasVote; batch-capable peers are
        # covered by the aggregate HasVotes digest loop (one bitmap per
        # vote set per tick instead of a per-vote flood — at committee
        # scale the flood itself was the congestion)
        if self.switch is None:
            return
        raw = None
        for peer in list(self.switch.peers.values()):
            if self._peer_supports_batch(peer):
                continue
            if raw is None:
                raw = encode_msg(
                    HasVoteMessage(
                        vote.height,
                        vote.round,
                        vote.type,
                        vote.validator_index,
                    )
                )
            peer.send(STATE_CHANNEL, raw)

    def _on_valid_block(self, rs) -> None:
        if self.switch is not None and rs.proposal_block_parts is not None:
            msg = NewValidBlockMessage(
                rs.height,
                rs.round,
                rs.proposal_block_parts.header,
                rs.proposal_block_parts.bit_array,
                rs.step == Step.COMMIT,
            )
            self.switch.broadcast(STATE_CHANNEL, encode_msg(msg))

    def _broadcast_own(self, msg) -> None:
        if self.switch is None:
            return
        if isinstance(msg, (ProposalMessage, BlockPartMessage)):
            if self.tracer.enabled:
                if isinstance(msg, ProposalMessage):
                    self._gossip_event(
                        "send",
                        "*",
                        msg.proposal.height,
                        msg.proposal.round,
                        type="proposal",
                    )
                else:
                    self._gossip_event(
                        "send",
                        "*",
                        msg.height,
                        msg.round,
                        type="block_part",
                        part=msg.part.index,
                    )
            self.switch.broadcast(DATA_CHANNEL, encode_msg(msg))
        elif isinstance(msg, VoteMessage):
            if self.tracer.enabled:
                self._vote_gossip_event("send", "*", msg.vote)
            self.switch.broadcast(VOTE_CHANNEL, encode_msg(msg))

    # --- causal gossip annotations ---------------------------------------

    def _gossip_event(
        self, direction: str, peer_id: str, height: int, round_: int, **fields
    ) -> None:
        """peer_id is the remote end: destination for sends ("*" = every
        connected peer via switch.broadcast), source for receives."""
        self.tracer.event(
            f"gossip.{direction}",
            height=height,
            round=round_,
            peer=peer_id,
            **fields,
        )

    def _vote_gossip_event(self, direction: str, peer_id: str, vote) -> None:
        self._gossip_event(
            direction,
            peer_id,
            vote.height,
            vote.round,
            type=VOTE_TYPE_NAMES.get(vote.type, str(vote.type)),
            val=vote.validator_index,
        )

    def _new_round_step_msg(self) -> NewRoundStepMessage:
        rs = self.cs.rs
        lcr = -1
        if rs.last_commit is not None:
            lcr = rs.last_commit.round
        return NewRoundStepMessage(
            height=rs.height,
            round=rs.round,
            step=int(rs.step),
            seconds_since_start_time=max(
                0, int((self.cs.now_ns() - rs.start_time_ns) / 1e9)
            ),
            last_commit_round=lcr,
        )

    # --- peer lifecycle ---------------------------------------------------

    async def add_peer(self, peer: Peer) -> None:
        prs = PeerRoundState()
        self._peer_states[peer.id] = prs
        loop = asyncio.get_running_loop()
        self._peer_tasks[peer.id] = [
            loop.create_task(self._gossip_data_routine(peer, prs)),
            loop.create_task(self._gossip_votes_routine(peer, prs)),
            loop.create_task(self._query_maj23_routine(peer, prs)),
        ]
        peer.send(STATE_CHANNEL, encode_msg(self._new_round_step_msg()))

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        for t in self._peer_tasks.pop(peer.id, []):
            t.cancel()
        self._peer_states.pop(peer.id, None)

    async def on_start(self) -> None:
        if self.vote_batch:
            self._digest_task = asyncio.get_running_loop().create_task(
                self._digest_routine()
            )

    async def on_stop(self) -> None:
        if self._digest_task is not None:
            self._digest_task.cancel()
            self._digest_task = None
        if self.vote_batcher is not None:
            self.vote_batcher.stop()
        if self.bls_batcher is not None:
            self.bls_batcher.stop()

    async def _digest_routine(self) -> None:
        """Broadcast aggregate HasVotes digests to batch-capable peers:
        one bitmap per changed vote set per gossip tick replaces the
        per-vote HasVote flood (O(committee) STATE messages per height
        per peer — at 100+ validators the flood itself congests the
        loop and relays re-ship votes whose announcements are still
        queued behind it)."""
        cs = self.cs
        last: dict[tuple[int, int, int], int] = {}
        try:
            while True:
                await asyncio.sleep(self.digest_interval)
                if self.switch is None:
                    continue
                rs = cs.rs
                sets = []
                if rs.votes is not None:
                    for vs in (
                        rs.votes.prevotes(rs.round),
                        rs.votes.precommits(rs.round),
                    ):
                        if vs is not None:
                            sets.append(vs)
                if rs.last_commit is not None:
                    sets.append(rs.last_commit)
                msgs = []
                for vs in sets:
                    bits = vs.bit_array()
                    key = (vs.height, vs.round, vs.signed_msg_type)
                    if bits._bits and last.get(key) != bits._bits:
                        last[key] = bits._bits
                        msgs.append(
                            encode_msg(
                                HasVotesMessage(
                                    vs.height,
                                    vs.round,
                                    vs.signed_msg_type,
                                    bits.copy(),
                                )
                            )
                        )
                if not msgs:
                    continue
                for peer in list(self.switch.peers.values()):
                    if not self._peer_supports_batch(peer):
                        continue
                    for raw in msgs:
                        peer.send(VOTE_BATCH_CHANNEL, raw)
                if len(last) > 64:
                    # height churn: keep only the recent keys
                    last = dict(list(last.items())[-16:])
        except asyncio.CancelledError:
            pass

    # --- receive ----------------------------------------------------------

    async def receive(self, channel_id: int, peer: Peer, msg_bytes: bytes) -> None:
        try:
            msg = decode_msg(msg_bytes)
        except ValueError as e:
            await self.switch.stop_peer_for_error(peer, f"bad consensus msg: {e}")
            return
        prs = self._peer_states.get(peer.id)
        if prs is None:
            return
        cs = self.cs
        if channel_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                prs.apply_new_round_step(msg)
            elif isinstance(msg, NewValidBlockMessage):
                if msg.height == prs.height:
                    prs.proposal_block_psh = msg.block_part_set_header
                    prs.proposal_block_parts = msg.block_parts
            elif isinstance(msg, HasVoteMessage):
                size = cs.state.validators.size()
                prs.set_has_vote(msg.height, msg.round, msg.type, msg.index, size)
            elif isinstance(msg, VoteSetMaj23Message):
                if msg.height != cs.rs.height:
                    return
                try:
                    cs.rs.votes.set_peer_maj23(
                        msg.round, msg.type, peer.id, msg.block_id
                    )
                except ValueError:
                    return
                # respond with our vote bits for that blockID
                vs = (
                    cs.rs.votes.prevotes(msg.round)
                    if msg.type == VoteType.PREVOTE
                    else cs.rs.votes.precommits(msg.round)
                )
                if vs is not None:
                    bits = vs.bit_array_by_block_id(msg.block_id)
                    if bits is not None:
                        peer.send(
                            VOTE_SET_BITS_CHANNEL,
                            encode_msg(
                                VoteSetBitsMessage(
                                    msg.height, msg.round, msg.type, msg.block_id, bits
                                )
                            ),
                        )
        elif channel_id == DATA_CHANNEL:
            if isinstance(msg, ProposalMessage):
                prs.proposal = True
                if prs.proposal_block_parts is None:
                    prs.proposal_block_psh = (
                        msg.proposal.block_id.part_set_header
                    )
                    prs.proposal_block_parts = BitArray(
                        msg.proposal.block_id.part_set_header.total
                    )
                prs.proposal_pol_round = msg.proposal.pol_round
                if self.tracer.enabled:
                    self._gossip_event(
                        "recv",
                        peer.id,
                        msg.proposal.height,
                        msg.proposal.round,
                        type="proposal",
                    )
                if cs.metrics is not None:
                    # proposer timestamp to our receipt; biased by the
                    # proposer-peer clock offset, which the per-peer
                    # offset gauge makes explicit
                    cs.metrics.proposal_gossip_seconds.observe(
                        max(
                            0.0,
                            (cs.now_ns() - msg.proposal.timestamp_ns) / 1e9,
                        ),
                        peer=bounded_label("consensus_gossip_peer", peer.id),
                    )
                await cs.add_proposal(msg.proposal, peer.id)
            elif isinstance(msg, ProposalPOLMessage):
                if msg.height == prs.height:
                    prs.proposal_pol_round = msg.proposal_pol_round
                    prs.proposal_pol = msg.proposal_pol
            elif isinstance(msg, BlockPartMessage):
                if prs.proposal_block_parts is not None:
                    prs.proposal_block_parts.set(msg.part.index, True)
                if self.tracer.enabled:
                    self._gossip_event(
                        "recv",
                        peer.id,
                        msg.height,
                        msg.round,
                        type="block_part",
                        part=msg.part.index,
                    )
                await cs.add_block_part(msg.height, msg.round, msg.part, peer.id)
        elif channel_id == VOTE_CHANNEL:
            if isinstance(msg, VoteMessage):
                if self.tracer.enabled:
                    self._vote_gossip_event("recv", peer.id, msg.vote)
                size = cs.state.validators.size()
                prs.set_has_vote(
                    msg.vote.height,
                    msg.vote.round,
                    msg.vote.type,
                    msg.vote.validator_index,
                    size,
                )
                # pre-verify through the micro-batcher: votes arriving
                # from all peers while the device is busy form one batch
                # (SURVEY.md §7.3 hard part 3); the await also applies
                # per-peer backpressure. The state machine skips its
                # serial check for pre-verified votes.
                vote = msg.vote
                pub = cs.pubkey_for_vote(vote)
                pre_verified = False
                if pub is not None and self.vote_batcher is not None:
                    pre_verified = await self.vote_batcher.submit(
                        pub.data,
                        vote.sign_bytes(cs.state.chain_id),
                        vote.signature,
                        key_type=getattr(pub, "type_name", "ed25519"),
                    )
                    if not pre_verified:
                        # the device already judged this signature invalid
                        # — don't hand it to the state machine for a
                        # second, serial verification on the event loop
                        self.logger.info(
                            "dropping invalid vote", peer=peer.id
                        )
                        await self.switch.stop_peer_for_error(
                            peer, "invalid vote signature"
                        )
                        return
                # batch-point precommits: pre-verify the BLS dual-signature
                # through the aggregate micro-batcher (the round's burst
                # costs 2 pairings total, not 2 per vote); the state
                # machine then skips its serial l2.verify_signature
                bls_pre_verified = False
                if (
                    pre_verified
                    and pub is not None
                    and vote.bls_signature
                    and self.bls_batcher is not None
                ):
                    batch_hash = cs.batch_hash_for_vote(vote)
                    if batch_hash:
                        ok = await self.bls_batcher.submit(
                            pub.data, batch_hash, vote.bls_signature
                        )
                        if ok is False:
                            # definitive rejection: the signature is bad
                            self.logger.info(
                                "dropping vote with invalid BLS signature",
                                peer=peer.id,
                            )
                            await self.switch.stop_peer_for_error(
                                peer, "invalid BLS signature on batch hash"
                            )
                            return
                        # ok None = verifier unavailable: fall through with
                        # bls_pre_verified=False; the state machine's serial
                        # check decides (don't punish the peer for it)
                        bls_pre_verified = ok is True
                await cs.peer_msg_queue.put(
                    (
                        VoteMessage(
                            vote,
                            pre_verified=pre_verified,
                            bls_pre_verified=bls_pre_verified,
                        ),
                        peer.id,
                    )
                )
        elif channel_id == VOTE_BATCH_CHANNEL:
            if isinstance(msg, VoteBatchMessage):
                await self._receive_vote_batch(peer, prs, msg)
            elif isinstance(msg, HasVotesMessage):
                # aggregate possession digest: fold into our view of
                # the peer so the gossip routines stop shipping votes
                # it already holds (never unsets — a digest is a floor)
                size = cs.state.validators.size()
                prs.get_votes_bits(
                    msg.height, msg.round, msg.type, size
                ).merge(msg.votes)
        elif channel_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage) and msg.height == cs.rs.height:
                vs = (
                    cs.rs.votes.prevotes(msg.round)
                    if msg.type == VoteType.PREVOTE
                    else cs.rs.votes.precommits(msg.round)
                )
                if vs is not None:
                    ours = vs.bit_array_by_block_id(msg.block_id)
                    if ours is not None:
                        # mark what the peer claims to have — MERGED
                        # into the existing bitmap (reference
                        # ApplyVoteSetBitsMessage ORs). Wholesale
                        # replacement wiped every send mark each maj23
                        # round-trip (the message only covers votes for
                        # ONE block id), so the gossip plane re-shipped
                        # the whole vote set every MAJ23_SLEEP — a
                        # recirculation pump that scales with committee
                        # size
                        table = (
                            prs.prevotes
                            if msg.type == VoteType.PREVOTE
                            else prs.precommits
                        )
                        cur = table.get(msg.round)
                        if cur is None or cur.size != msg.votes.size:
                            table[msg.round] = msg.votes
                        else:
                            cur.merge(msg.votes)

    async def _receive_vote_batch(
        self, peer: Peer, prs: PeerRoundState, msg: VoteBatchMessage
    ) -> None:
        """Accept a whole vote chunk: mark the peer's possession bits,
        drop votes we already hold verbatim, pre-verify the remainder as
        ONE micro-batcher submission (one scheduler dispatch round), run
        the batch-point BLS dual-signs as one aggregate round, and feed
        the state machine a single batch message instead of N queue
        puts. Per-vote semantics (invalid signature => peer stopped,
        serial-fallback on BLS-verifier outage) match the single-vote
        path exactly."""
        cs = self.cs
        votes = msg.votes
        if not votes:
            return
        if len(votes) > VOTE_BATCH_MAX_ACCEPT:
            await self.switch.stop_peer_for_error(
                peer, f"oversized vote batch ({len(votes)})"
            )
            return
        if self.tracer.enabled:
            self._gossip_event(
                "recv",
                peer.id,
                msg.height,
                msg.round,
                type="vote_batch",
                n=len(votes),
            )
        size = cs.state.validators.size()
        for v in votes:
            prs.set_has_vote(v.height, v.round, v.type, v.validator_index, size)
        # exact duplicates we already accepted are pure relay echo at
        # committee scale (the same vote reaches us along several gossip
        # paths): skip their signature work entirely. Only a VERBATIM
        # match is skipped — a differing signature from the same index
        # still goes through (it may be equivocation evidence).
        fresh = [v for v in votes if not self._have_identical_vote(v)]
        if not fresh:
            return
        pubs = [cs.pubkey_for_vote(v) for v in fresh]
        pre = [False] * len(fresh)
        if self.vote_batcher is not None:
            sigs = []
            sig_idx = []
            for i, (v, pub) in enumerate(zip(fresh, pubs)):
                if pub is not None:
                    sigs.append(
                        (
                            pub.data,
                            v.sign_bytes(cs.state.chain_id),
                            v.signature,
                            getattr(pub, "type_name", "ed25519"),
                        )
                    )
                    sig_idx.append(i)
            if sigs:
                verdicts = await self.vote_batcher.submit_many(sigs)
                for i, ok in zip(sig_idx, verdicts):
                    if not ok:
                        self.logger.info(
                            "dropping vote batch with invalid vote",
                            peer=peer.id,
                        )
                        await self.switch.stop_peer_for_error(
                            peer, "invalid vote signature in batch"
                        )
                        return
                    pre[i] = True
        bls = [False] * len(fresh)
        if self.bls_batcher is not None:
            checks = []
            bls_idx = []
            for i, (v, pub) in enumerate(zip(fresh, pubs)):
                if pre[i] and pub is not None and v.bls_signature:
                    batch_hash = cs.batch_hash_for_vote(v)
                    if batch_hash:
                        checks.append((pub.data, batch_hash, v.bls_signature))
                        bls_idx.append(i)
            if checks:
                verdicts = await self.bls_batcher.submit_many(checks)
                for i, ok in zip(bls_idx, verdicts):
                    if ok is False:
                        self.logger.info(
                            "dropping vote batch with invalid BLS signature",
                            peer=peer.id,
                        )
                        await self.switch.stop_peer_for_error(
                            peer, "invalid BLS signature on batch hash"
                        )
                        return
                    # ok None = verifier unavailable: leave the flag
                    # down, the state machine's serial check decides
                    bls[i] = ok is True
        await cs.peer_msg_queue.put(
            (
                VoteBatchMessage(
                    msg.height,
                    msg.round,
                    msg.type,
                    fresh,
                    pre_verified=pre,
                    bls_pre_verified=bls,
                ),
                peer.id,
            )
        )
        # eager relay: forward the VERIFIED slice of the chunk NOW,
        # while it is still a chunk — waiting for the pull loop would
        # re-trickle it in 50 ms deltas, dissolving the burstiness that
        # makes batched gossip cheap down the relay tree. Only votes
        # that passed OUR pre-verification forward: an unresolvable
        # vote (pubkey_for_vote None) can never be marked or deduped —
        # relaying it would let one hostile chunk of bogus indices
        # circulate the batch plane forever
        self._forward_vote_batch(
            peer, [v for v, ok in zip(fresh, pre) if ok]
        )

    def _ship_batch(
        self,
        peer: Peer,
        theirs: BitArray,
        height: int,
        round_: int,
        vtype: int,
        votes: list[Vote],
        idxs: list[int],
    ) -> int:
        """Send one VoteBatchMessage and do the shared bookkeeping:
        mark the peer's possession bits, count the batch, observe the
        size metric, emit the causal trace event. Returns votes sent
        (0 = send failed, nothing marked)."""
        if not peer.send(
            VOTE_BATCH_CHANNEL,
            encode_msg(VoteBatchMessage(height, round_, vtype, votes)),
        ):
            return 0
        theirs.update(idxs)
        self.gossip_batches_sent += 1
        if self.cs.metrics is not None:
            self.cs.metrics.vote_batch_size.observe(len(votes))
        if self.tracer.enabled:
            # one causal event per chunk (per-vote events at committee
            # scale would flood the span ring)
            self._gossip_event(
                "send",
                peer.id,
                height,
                round_,
                type="vote_batch",
                vtype=VOTE_TYPE_NAMES.get(vtype, str(vtype)),
                n=len(votes),
            )
        return len(votes)

    def _forward_vote_batch(
        self, src_peer: Peer, votes: list[Vote]
    ) -> None:
        """Relay a just-accepted, pre-verified chunk to up to
        `vote_forward_fanout` batch-capable peers that (by our
        bookkeeping) miss at least the committee fill floor of it.
        Terminates: every send marks the peer's bits first, the receive
        side drops verbatim-known votes from 'fresh', and sub-min
        residues are left to the paced pull plane — so a vote crosses
        each edge at most once per direction."""
        if not votes or self.switch is None or self.vote_forward_fanout <= 0:
            return
        size = self.cs.state.validators.size()
        cur_height = self.cs.rs.height
        groups: dict[tuple[int, int, int], list[Vote]] = {}
        for v in votes:
            # only current-height votes forward eagerly: catchup and
            # last-commit stragglers stay on the paced pull plane,
            # where per-peer bookkeeping is height-aware
            if v.height != cur_height:
                continue
            groups.setdefault((v.height, v.round, v.type), []).append(v)
        if not groups:
            return
        candidates = [
            p
            for p in self.switch.peers.values()
            if p.id != src_peer.id and self._peer_supports_batch(p)
        ]
        if len(candidates) > self.vote_forward_fanout:
            # rotation-randomized subset: epidemic fanout, not flood —
            # different chunks pick different successors
            start = secrets.randbelow(len(candidates))
            candidates = (candidates[start:] + candidates[:start])[
                : self.vote_forward_fanout
            ]
        for peer in candidates:
            prs = self._peer_states.get(peer.id)
            if prs is None:
                continue
            for (h, r, ty), group in groups.items():
                # only to peers whose round state can accept these now:
                # same height, or — for precommits only — one height
                # ahead, where they land in the peer's LastCommit
                # window. Any other (height, type) gets a DETACHED
                # bitmap from get_votes_bits: marks would be lost and
                # the votes dropped, so the same chunk would re-ship on
                # every fresh receive.
                if not (
                    prs.height == h
                    or (
                        prs.height == h + 1
                        and ty == VoteType.PRECOMMIT
                    )
                ):
                    continue
                theirs = prs.get_votes_bits(h, r, ty, size)
                sub = [
                    v for v in group if not theirs.get(v.validator_index)
                ]
                if len(sub) < max(VOTE_BATCH_MIN_FILL, size // 16):
                    continue
                sent = self._ship_batch(
                    peer,
                    theirs,
                    h,
                    r,
                    ty,
                    sub,
                    [v.validator_index for v in sub],
                )
                if sent:
                    self._note_gossip_tick(sent)

    def _have_identical_vote(self, vote: Vote) -> bool:
        """True iff we already hold this exact vote (same signature) —
        current height's sets, or LastCommit for previous-height
        precommits (without the latter, relayed commit stragglers are
        'fresh' forever and keep circulating). Signature equality
        implies content equality — the stored vote was verified over
        its sign bytes."""
        rs = self.cs.rs
        vs = None
        if vote.height == rs.height and rs.votes is not None:
            vs = (
                rs.votes.prevotes(vote.round)
                if vote.type == VoteType.PREVOTE
                else rs.votes.precommits(vote.round)
            )
        elif (
            vote.height + 1 == rs.height
            and vote.type == VoteType.PRECOMMIT
            and rs.last_commit is not None
            and rs.last_commit.round == vote.round
        ):
            vs = rs.last_commit
        if vs is None or not 0 <= vote.validator_index < vs.size():
            return False
        existing = vs.get_by_index(vote.validator_index)
        return existing is not None and existing.signature == vote.signature

    # --- gossip routines --------------------------------------------------

    async def _gossip_data_routine(self, peer: Peer, prs: PeerRoundState) -> None:
        """reference gossipDataRoutine :531 + catchup :628."""
        cs = self.cs
        try:
            while True:
                rs = cs.rs
                # 1. send proposal block parts the peer is missing
                if (
                    rs.height == prs.height
                    and rs.proposal_block_parts is not None
                    and prs.proposal_block_parts is not None
                    and rs.proposal_block_parts.header == prs.proposal_block_psh
                ):
                    ours = rs.proposal_block_parts.bit_array
                    missing = ours.sub(prs.proposal_block_parts)
                    idx, ok = missing.pick_random()
                    if ok:
                        part = rs.proposal_block_parts.get_part(idx)
                        if part is not None and peer.send(
                            DATA_CHANNEL,
                            encode_msg(
                                BlockPartMessage(rs.height, rs.round, part)
                            ),
                        ):
                            if self.tracer.enabled:
                                self._gossip_event(
                                    "send",
                                    peer.id,
                                    rs.height,
                                    rs.round,
                                    type="block_part",
                                    part=idx,
                                )
                            prs.proposal_block_parts.set(idx, True)
                            continue
                # 2. peer is on an older height: catch them up from the store
                if (
                    prs.height > 0
                    and prs.height < rs.height
                    and prs.height >= cs.block_store.base
                ):
                    await self._gossip_catchup(peer, prs)
                    continue
                # 3. send the proposal itself
                if (
                    rs.height == prs.height
                    and rs.proposal is not None
                    and not prs.proposal
                ):
                    if peer.send(
                        DATA_CHANNEL, encode_msg(ProposalMessage(rs.proposal))
                    ):
                        if self.tracer.enabled:
                            self._gossip_event(
                                "send",
                                peer.id,
                                rs.height,
                                rs.round,
                                type="proposal",
                            )
                        prs.proposal = True
                        # reference SetHasProposal (:1043): knowing the
                        # proposal implies knowing its part-set header,
                        # so initialize the peer's part bitmap — without
                        # this, branch 1 above never fires for a peer we
                        # proposed to and parts only flow after a
                        # NewValidBlock round-trip (invisible on a full
                        # mesh where the proposer pushes parts directly,
                        # a stall on sparse committee topologies)
                        if prs.proposal_block_parts is None:
                            psh = rs.proposal.block_id.part_set_header
                            prs.proposal_block_psh = psh
                            prs.proposal_block_parts = BitArray(psh.total)
                        if 0 <= rs.proposal.pol_round:
                            pv = rs.votes.prevotes(rs.proposal.pol_round)
                            if pv is not None:
                                peer.send(
                                    DATA_CHANNEL,
                                    encode_msg(
                                        ProposalPOLMessage(
                                            rs.height,
                                            rs.proposal.pol_round,
                                            pv.bit_array(),
                                        )
                                    ),
                                )
                # ALWAYS yield: a failed send (full queue) must not spin
                # the loop — one non-awaiting coroutine starves asyncio
                await asyncio.sleep(GOSSIP_SLEEP)
        except asyncio.CancelledError:
            pass

    async def _gossip_catchup(self, peer: Peer, prs: PeerRoundState) -> None:
        """Send parts of the committed block at the peer's height."""
        meta = self.cs.block_store.load_block_meta(prs.height)
        if meta is None:
            await asyncio.sleep(GOSSIP_SLEEP)
            return
        if (
            prs.proposal_block_psh != meta.block_id.part_set_header
            or prs.proposal_block_parts is None
        ):
            prs.proposal_block_psh = meta.block_id.part_set_header
            prs.proposal_block_parts = BitArray(
                meta.block_id.part_set_header.total
            )
        ours = BitArray.from_indices(
            meta.block_id.part_set_header.total,
            range(meta.block_id.part_set_header.total),
        )
        missing = ours.sub(prs.proposal_block_parts)
        idx, ok = missing.pick_random()
        if not ok:
            await asyncio.sleep(GOSSIP_SLEEP)
            return
        part = self.cs.block_store.load_block_part(prs.height, idx)
        if part is None:
            await asyncio.sleep(GOSSIP_SLEEP)
            return
        if peer.send(
            DATA_CHANNEL,
            encode_msg(BlockPartMessage(prs.height, prs.round, part)),
        ):
            if self.tracer.enabled:
                self._gossip_event(
                    "send",
                    peer.id,
                    prs.height,
                    prs.round,
                    type="block_part",
                    part=idx,
                )
            prs.proposal_block_parts.set(idx, True)
        else:
            # failed send (full queue / stopping mconn): MUST yield — the
            # caller `continue`s straight back here, and a no-await spin
            # starves the loop and can never even be cancelled (seen as a
            # teardown hang with a catching-up peer)
            await asyncio.sleep(GOSSIP_SLEEP)

    async def _gossip_votes_routine(self, peer: Peer, prs: PeerRoundState) -> None:
        """reference gossipVotesRoutine :671, batched: each tick ships
        ALL the votes the peer is missing for one vote set (bounded
        chunks) to a batch-capable peer, or one vote to a legacy peer."""
        cs = self.cs
        batch_ok = self._peer_supports_batch(peer)
        # consecutive passes without a send: gates VOTE_BATCH_MIN_FILL
        # so tiny chunks wait ≤ HOLDBACK x GOSSIP_SLEEP for the peer's
        # HasVote dedupe (or more missing votes) before shipping
        holdback = VOTE_BATCH_HOLDBACK_TICKS
        try:
            while True:
                rs = cs.rs
                # committee-scaled fill floor: at 100+ validators a
                # 4-vote chunk is still mostly framing — wait for
                # ~1/16th of the committee unless the holdback expired
                min_fill = (
                    1
                    if holdback >= VOTE_BATCH_HOLDBACK_TICKS
                    else max(
                        VOTE_BATCH_MIN_FILL,
                        cs.state.validators.size() // 16,
                    )
                )
                sent = 0
                if rs.height == prs.height and rs.votes is not None:
                    # current round prevotes + precommits, peer's POL round
                    for vtype, vs in (
                        (VoteType.PREVOTE, rs.votes.prevotes(prs.round)),
                        (VoteType.PRECOMMIT, rs.votes.precommits(prs.round)),
                    ):
                        if vs is None:
                            continue
                        sent = self._send_missing_votes(
                            peer, prs, vs, batch_ok, min_fill=min_fill
                        )
                        if sent:
                            break
                elif (
                    rs.height == prs.height + 1
                    and rs.last_commit is not None
                ):
                    # peer finishing the previous height: our last commit
                    sent = self._send_missing_votes(
                        peer, prs, rs.last_commit, batch_ok,
                        min_fill=min_fill,
                    )
                elif (
                    prs.height > 0
                    and prs.height < rs.height
                    and prs.height >= cs.block_store.base
                ):
                    # deep catchup: the stored seen-commit for their height
                    commit = cs.block_store.load_seen_commit(prs.height)
                    if commit is not None:
                        sent = self._send_commit_votes(
                            peer, prs, commit, batch_ok
                        )
                holdback = 0 if sent else holdback + 1
                self._note_gossip_tick(sent)
                if not sent:
                    await asyncio.sleep(GOSSIP_SLEEP)
                elif batch_ok and sent < self.vote_batch_max:
                    # the chunk drained everything the peer was missing:
                    # pace the next pass so fresh arrivals accumulate
                    # into one chunk — looping immediately would re-ship
                    # per arrival, i.e. one-vote messages again, just on
                    # the batch channel. A FULL chunk means backlog
                    # remains, so that case loops straight back. The
                    # legacy single-vote path keeps the original
                    # no-sleep-after-send cadence.
                    await asyncio.sleep(GOSSIP_SLEEP)
        except asyncio.CancelledError:
            pass

    def _note_gossip_tick(self, sent: int) -> None:
        if sent:
            self.gossip_ticks += 1
            self.gossip_votes_sent += sent
        else:
            self.gossip_idle_ticks += 1
        metrics = self.cs.metrics
        if metrics is not None and sent:
            metrics.vote_gossip_ticks.inc()
            metrics.vote_gossip_votes.inc(sent)

    def _send_missing_votes(
        self,
        peer: Peer,
        prs: PeerRoundState,
        vote_set,
        batch_ok: bool,
        min_fill: int = 1,
    ) -> int:
        """Send votes from `vote_set` the peer is missing; returns how
        many were sent. Batch-capable peers get one VoteBatchMessage
        with up to vote_batch_max votes (withheld while fewer than
        `min_fill` are missing — the caller's holdback guarantees
        eventual shipment); legacy peers get the original
        one-random-vote-per-tick."""
        ours = vote_set.bit_array()
        theirs = prs.get_votes_bits(
            vote_set.height, vote_set.round, vote_set.signed_msg_type, ours.size
        )
        missing = ours.sub(theirs)
        if not batch_ok:
            idx, ok = missing.pick_random()
            if not ok:
                return 0
            vote = vote_set.get_by_index(idx)
            if vote is None:
                return 0
            if peer.send(VOTE_CHANNEL, encode_msg(VoteMessage(vote))):
                if self.tracer.enabled:
                    self._vote_gossip_event("send", peer.id, vote)
                theirs.set(idx, True)
                return 1
            return 0
        if missing.num_set() < min_fill:
            return 0
        idxs = missing.pick_chunk(self.vote_batch_max)
        votes = []
        sent_idxs = []
        for idx in idxs:
            vote = vote_set.get_by_index(idx)
            if vote is not None:
                votes.append(vote)
                sent_idxs.append(idx)
        if not votes:
            return 0
        return self._ship_batch(
            peer,
            theirs,
            vote_set.height,
            vote_set.round,
            vote_set.signed_msg_type,
            votes,
            sent_idxs,
        )

    def _send_commit_votes(
        self, peer: Peer, prs: PeerRoundState, commit, batch_ok: bool
    ) -> int:
        """Reconstruct precommit votes from a stored commit for catchup,
        up to a per-tick budget (the old code returned after the FIRST
        vote sent, so an N-validator catchup cost N ticks x
        GOSSIP_SLEEP); batch-capable peers get the whole chunk as one
        VoteBatchMessage. Returns votes sent."""
        from ..types.block_id import BlockID

        theirs = prs.get_votes_bits(
            commit.height, commit.round, VoteType.PRECOMMIT, commit.size()
        )
        budget = self.vote_batch_max if batch_ok else COMMIT_CATCHUP_BUDGET
        votes = []
        sent_idxs = []
        for i, csig in enumerate(commit.signatures):
            if len(votes) >= budget:
                break
            if csig.is_absent() or theirs.get(i):
                continue
            votes.append(
                Vote(
                    type=VoteType.PRECOMMIT,
                    height=commit.height,
                    round=commit.round,
                    block_id=(
                        commit.block_id if csig.for_block() else BlockID()
                    ),
                    timestamp_ns=csig.timestamp_ns,
                    validator_address=csig.validator_address,
                    validator_index=i,
                    signature=csig.signature,
                    bls_signature=csig.bls_signature,
                )
            )
            sent_idxs.append(i)
        if not votes:
            return 0
        if batch_ok:
            return self._ship_batch(
                peer,
                theirs,
                commit.height,
                commit.round,
                VoteType.PRECOMMIT,
                votes,
                sent_idxs,
            )
        sent = 0
        for idx, vote in zip(sent_idxs, votes):
            if not peer.send(VOTE_CHANNEL, encode_msg(VoteMessage(vote))):
                break  # full queue: stop burning encodes this tick
            if self.tracer.enabled:
                self._vote_gossip_event("send", peer.id, vote)
            theirs.set(idx, True)
            sent += 1
        return sent

    async def _query_maj23_routine(self, peer: Peer, prs: PeerRoundState) -> None:
        """reference queryMaj23Routine :804: periodically tell peers which
        blocks we saw 2/3 for, so they can send us missing votes."""
        cs = self.cs
        try:
            while True:
                await asyncio.sleep(MAJ23_SLEEP)
                rs = cs.rs
                if rs.height != prs.height or rs.votes is None:
                    continue
                for vtype, vs in (
                    (VoteType.PREVOTE, rs.votes.prevotes(rs.round)),
                    (VoteType.PRECOMMIT, rs.votes.precommits(rs.round)),
                ):
                    if vs is None:
                        continue
                    bid, ok = vs.two_thirds_majority()
                    if ok:
                        peer.send(
                            STATE_CHANNEL,
                            encode_msg(
                                VoteSetMaj23Message(
                                    rs.height, rs.round, vtype, bid
                                )
                            ),
                        )
        except asyncio.CancelledError:
            pass
