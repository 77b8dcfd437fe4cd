"""Synchronous in-process event switch.

Reference: libs/events (284 LoC, `events.EventSwitch`) — the consensus
reactor fast path subscribes to new-round-step/vote/proposal-heartbeat
events synchronously (consensus/state.go:152). Callbacks run inline on the
publisher; this is deliberate — the consensus loop relies on the reactor's
state snapshot being updated before the next message is processed.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable


class EventSwitch:
    def __init__(self) -> None:
        self._listeners: dict[str, dict[str, Callable[[Any], None]]] = (
            defaultdict(dict)
        )

    def add_listener(
        self, listener_id: str, event: str, cb: Callable[[Any], None]
    ) -> None:
        self._listeners[event][listener_id] = cb

    def remove_listener(self, listener_id: str) -> None:
        for handlers in self._listeners.values():
            handlers.pop(listener_id, None)

    def fire_event(self, event: str, data: Any) -> None:
        for cb in list(self._listeners.get(event, {}).values()):
            cb(data)
