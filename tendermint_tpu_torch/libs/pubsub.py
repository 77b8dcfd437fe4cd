"""Queryable pub/sub server — the event spine behind RPC subscriptions and
tx indexing.

Reference: libs/pubsub (2,721 LoC) + its query language. Events are
published with a message and a map of string tags (`events`); subscribers
register a Query that filters on those tags. The query language here covers
the grammar the reference's indexer and websocket subscriptions actually
use: `key = 'value'`, `key < / <= / > / >= number`, `key EXISTS`,
`key CONTAINS 'substr'`, joined by AND.
"""

from __future__ import annotations

import asyncio
import re
from dataclasses import dataclass, field
from typing import Any, Optional


# --- query language -------------------------------------------------------

_COND_RE = re.compile(
    r"\s*([\w.]+)\s*(=|<=|>=|<|>|EXISTS|CONTAINS)\s*('(?:[^']*)'|[\d.]+)?\s*",
)


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    value: Any = None


def _split_and(s: str) -> list[str]:
    """Split on ' AND ' outside single-quoted values."""
    parts, buf, in_quote = [], [], False
    i = 0
    while i < len(s):
        c = s[i]
        if c == "'":
            in_quote = not in_quote
        if not in_quote and s.startswith(" AND ", i):
            parts.append("".join(buf))
            buf = []
            i += 5
            continue
        buf.append(c)
        i += 1
    parts.append("".join(buf))
    return parts


class Query:
    """AND-composed conditions over event tag maps (libs/pubsub/query)."""

    def __init__(self, query_str: str):
        self.query_str = query_str.strip()
        self.conditions: list[Condition] = []
        if self.query_str:
            for part in _split_and(self.query_str):
                m = _COND_RE.fullmatch(part)
                if not m:
                    raise ValueError(f"invalid query condition: {part!r}")
                key, op, raw = m.group(1), m.group(2), m.group(3)
                if op in ("EXISTS",):
                    val = None
                elif raw is None:
                    raise ValueError(f"missing value in condition: {part!r}")
                elif raw.startswith("'"):
                    val = raw[1:-1]
                else:
                    val = float(raw) if "." in raw else int(raw)
                self.conditions.append(Condition(key, op, val))

    def matches(self, events: dict[str, list[str]]) -> bool:
        for cond in self.conditions:
            values = events.get(cond.key)
            if values is None:
                return False
            if cond.op == "EXISTS":
                continue
            ok = False
            for v in values:
                if cond.op == "=":
                    ok = v == str(cond.value) or _num_eq(v, cond.value)
                elif cond.op == "CONTAINS":
                    ok = str(cond.value) in v
                else:
                    try:
                        n = float(v)
                    except ValueError:
                        continue
                    t = float(cond.value)
                    ok = {
                        "<": n < t,
                        "<=": n <= t,
                        ">": n > t,
                        ">=": n >= t,
                    }[cond.op]
                if ok:
                    break
            if not ok:
                return False
        return True

    def __str__(self) -> str:
        return self.query_str

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self.query_str == other.query_str

    def __hash__(self) -> int:
        return hash(self.query_str)


def _num_eq(v: str, target: Any) -> bool:
    if not isinstance(target, (int, float)):
        return False
    try:
        return float(v) == float(target)
    except ValueError:
        return False


# --- server ---------------------------------------------------------------


@dataclass
class Message:
    data: Any
    events: dict[str, list[str]]


@dataclass
class Subscription:
    subscriber: str
    query: Query
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue())
    cancelled: Optional[str] = None  # reason, if cancelled

    async def next(self) -> Message:
        msg = await self.queue.get()
        if isinstance(msg, _Cancelled):
            raise SubscriptionCancelled(msg.reason)
        return msg


@dataclass
class _Cancelled:
    reason: str


class SubscriptionCancelled(Exception):
    pass


class PubSubServer:
    """In-proc async pub/sub. Unbuffered-queue semantics of the reference are
    softened: each subscription gets a bounded queue; slow subscribers are
    cancelled (the reference's ErrOutOfCapacity behavior)."""

    def __init__(self, capacity: int = 1024):
        self._subs: dict[tuple[str, str], Subscription] = {}
        self._capacity = capacity

    def subscribe(
        self, subscriber: str, query: Query, capacity: Optional[int] = None
    ) -> Subscription:
        key = (subscriber, query.query_str)
        if key in self._subs:
            raise ValueError("already subscribed")
        sub = Subscription(subscriber, query)
        sub.queue = asyncio.Queue(capacity or self._capacity)
        self._subs[key] = sub
        return sub

    @staticmethod
    def _deliver_cancel(sub: Subscription, reason: str) -> None:
        """Guarantee the cancellation sentinel lands even on a full queue."""
        try:
            sub.queue.put_nowait(_Cancelled(reason))
        except asyncio.QueueFull:
            sub.queue.get_nowait()  # drop oldest to make room
            sub.queue.put_nowait(_Cancelled(reason))

    def unsubscribe(self, subscriber: str, query: Query) -> None:
        key = (subscriber, query.query_str)
        sub = self._subs.pop(key, None)
        if sub is None:
            raise KeyError("subscription not found")
        self._deliver_cancel(sub, "unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        for key in [k for k in self._subs if k[0] == subscriber]:
            self._deliver_cancel(self._subs.pop(key), "unsubscribed")

    def num_clients(self) -> int:
        return len({k[0] for k in self._subs})

    def num_client_subscriptions(self, subscriber: str) -> int:
        return sum(1 for k in self._subs if k[0] == subscriber)

    async def publish(self, data: Any, events: dict[str, list[str]]) -> None:
        msg = Message(data, events)
        for key, sub in list(self._subs.items()):
            if sub.query.matches(events):
                try:
                    sub.queue.put_nowait(msg)
                except asyncio.QueueFull:
                    # cancel the laggard, as the reference does
                    self._subs.pop(key, None)
                    while not sub.queue.empty():
                        sub.queue.get_nowait()
                    self._deliver_cancel(sub, "out of capacity")
