"""EventBus — typed publishers over the pubsub server.

Reference: types/event_bus.go:33 (EventBus wrapping pubsub.Server with
typed publish methods :102-161) + types/events.go event names. RPC
websocket subscriptions and the tx/block indexers all hang off this.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..libs.pubsub import PubSubServer, Query, Subscription

# event type tag (reference types/events.go)
EVENT_TYPE_KEY = "tm.event"
TX_HASH_KEY = "tx.hash"
TX_HEIGHT_KEY = "tx.height"
BLOCK_HEIGHT_KEY = "block.height"

EventNewBlock = "NewBlock"
EventNewBlockHeader = "NewBlockHeader"
EventNewRound = "NewRound"
EventNewRoundStep = "NewRoundStep"
EventCompleteProposal = "CompleteProposal"
EventPolka = "Polka"
EventLock = "Lock"
EventRelock = "Relock"
EventTimeoutPropose = "TimeoutPropose"
EventTimeoutWait = "TimeoutWait"
EventUnlock = "Unlock"
EventValidBlock = "ValidBlock"
EventVote = "Vote"
EventTx = "Tx"
EventValidatorSetUpdates = "ValidatorSetUpdates"
EventNewEvidence = "NewEvidence"


def query_for_event(event_type: str) -> Query:
    return Query(f"{EVENT_TYPE_KEY} = '{event_type}'")


class EventBus:
    def __init__(self):
        self._server = PubSubServer()

    def subscribe(
        self, subscriber: str, query: Query, capacity: Optional[int] = None
    ) -> Subscription:
        return self._server.subscribe(subscriber, query, capacity)

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        self._server.unsubscribe(subscriber, query)

    def unsubscribe_all(self, subscriber: str) -> None:
        self._server.unsubscribe_all(subscriber)

    def num_clients(self) -> int:
        return self._server.num_clients()

    def num_client_subscriptions(self, subscriber: str) -> int:
        return self._server.num_client_subscriptions(subscriber)

    async def _publish(
        self, event_type: str, data: Any, extra: Optional[dict] = None
    ) -> None:
        events = {EVENT_TYPE_KEY: [event_type]}
        if extra:
            for k, v in extra.items():
                events.setdefault(k, []).extend(v)
        await self._server.publish(data, events)

    async def publish_new_block(
        self, block, result_events: Optional[dict] = None
    ) -> None:
        extra = {BLOCK_HEIGHT_KEY: [str(block.header.height)]}
        if result_events:
            for k, v in result_events.items():
                extra.setdefault(k, []).extend(v)
        await self._publish(EventNewBlock, block, extra)

    async def publish_new_block_header(self, header) -> None:
        await self._publish(
            EventNewBlockHeader,
            header,
            {BLOCK_HEIGHT_KEY: [str(header.height)]},
        )

    async def publish_tx(
        self,
        height: int,
        tx_hash: bytes,
        tx: bytes,
        result_events: Optional[dict] = None,
    ) -> None:
        extra = {
            TX_HASH_KEY: [tx_hash.hex().upper()],
            TX_HEIGHT_KEY: [str(height)],
        }
        if result_events:
            for k, v in result_events.items():
                extra.setdefault(k, []).extend(v)
        await self._publish(EventTx, (height, tx_hash, tx), extra)

    async def publish_vote(self, vote) -> None:
        await self._publish(EventVote, vote)

    async def publish_new_round_step(self, rs) -> None:
        await self._publish(EventNewRoundStep, rs)

    async def publish_new_round(self, rs) -> None:
        await self._publish(EventNewRound, rs)

    async def publish_complete_proposal(self, rs) -> None:
        await self._publish(EventCompleteProposal, rs)

    async def publish_polka(self, rs) -> None:
        await self._publish(EventPolka, rs)

    async def publish_lock(self, rs) -> None:
        await self._publish(EventLock, rs)

    async def publish_unlock(self, rs) -> None:
        await self._publish(EventUnlock, rs)

    async def publish_relock(self, rs) -> None:
        await self._publish(EventRelock, rs)

    async def publish_timeout_propose(self, rs) -> None:
        await self._publish(EventTimeoutPropose, rs)

    async def publish_timeout_wait(self, rs) -> None:
        await self._publish(EventTimeoutWait, rs)

    async def publish_valid_block(self, rs) -> None:
        await self._publish(EventValidBlock, rs)

    async def publish_validator_set_updates(self, updates) -> None:
        await self._publish(EventValidatorSetUpdates, updates)

    async def publish_new_evidence(self, evidence, height: int) -> None:
        await self._publish(
            EventNewEvidence, (evidence, height)
        )
