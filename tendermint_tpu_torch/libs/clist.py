"""CList — ordered list with async next-waiting (reference libs/clist).

The reference's concurrent linked list backs evidence/pex gossip
iteration: a reader holds a cursor and blocks until a next element
exists. The asyncio port keeps the same surface: `front()`, element
`next_wait()`, `push_back`, `remove`.
"""

from __future__ import annotations

import asyncio
from typing import Any, Optional


class CElement:
    def __init__(self, value: Any, lst: "CList"):
        self.value = value
        self._list = lst
        self.prev: Optional[CElement] = None
        self.next: Optional[CElement] = None
        self.removed = False
        self._next_ev = asyncio.Event()

    async def next_wait(self) -> Optional["CElement"]:
        """Block until a next element exists (or this one is removed)."""
        while True:
            if self.next is not None:
                return self.next
            if self.removed:
                return None
            self._next_ev.clear()
            await self._next_ev.wait()

    def detach_prev(self) -> None:
        self.prev = None

    def detach_next(self) -> None:
        self.next = None


class CList:
    def __init__(self, max_length: int = 0):
        self.head: Optional[CElement] = None
        self.tail: Optional[CElement] = None
        self._len = 0
        self._max = max_length
        self._wait_ev = asyncio.Event()

    def __len__(self) -> int:
        return self._len

    def front(self) -> Optional[CElement]:
        return self.head

    def back(self) -> Optional[CElement]:
        return self.tail

    async def front_wait(self) -> CElement:
        while self.head is None:
            self._wait_ev.clear()
            await self._wait_ev.wait()
        return self.head

    def push_back(self, value: Any) -> CElement:
        if self._max and self._len >= self._max:
            raise OverflowError("clist full")
        el = CElement(value, self)
        if self.tail is None:
            self.head = self.tail = el
        else:
            el.prev = self.tail
            self.tail.next = el
            self.tail._next_ev.set()
            self.tail = el
        self._len += 1
        self._wait_ev.set()
        return el

    def remove(self, el: CElement) -> Any:
        if el.removed:
            return el.value
        if el.prev is not None:
            el.prev.next = el.next
        else:
            self.head = el.next
        if el.next is not None:
            el.next.prev = el.prev
        else:
            self.tail = el.prev
        el.removed = True
        el._next_ev.set()
        self._len -= 1
        return el.value

    def __iter__(self):
        el = self.head
        while el is not None:
            yield el.value
            el = el.next
