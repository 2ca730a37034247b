"""Intrusive doubly-linked queue.

Rebuild of the reference's `lib/queue.js:13-75`: a sentinel-node circular
doubly-linked list giving O(1) push/shift and — the important part — O(1)
removal from the middle via the node handle, which the pool uses to pull
cancelled waiters and stale idle slots out of its queues without scanning
(reference lib/pool.js:191-193 idleq/initq/waiters usage).
"""

from __future__ import annotations

import typing


class QueueNode:
    __slots__ = ('value', 'prev', 'next', '_queue')

    def __init__(self, value, queue: 'Queue | None'):
        self.value = value
        self.prev: 'QueueNode | None' = None
        self.next: 'QueueNode | None' = None
        self._queue = queue

    def remove(self) -> None:
        """Unlink this node from its queue; idempotent."""
        if self._queue is None:
            return
        q = self._queue
        assert self.prev is not None and self.next is not None
        self.prev.next = self.next
        self.next.prev = self.prev
        self.prev = None
        self.next = None
        self._queue = None
        q._length -= 1

    def is_queued(self) -> bool:
        return self._queue is not None


class Queue:
    """FIFO with O(1) arbitrary removal. Iteration yields values."""

    def __init__(self) -> None:
        # Sentinel head: head.next is front, head.prev is back.
        self._head = QueueNode(None, None)
        self._head.prev = self._head
        self._head.next = self._head
        self._length = 0

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    def is_empty(self) -> bool:
        return self._length == 0

    def push(self, value) -> QueueNode:
        """Append to the back; returns the node handle."""
        node = QueueNode(value, self)
        back = self._head.prev
        assert back is not None
        node.prev = back
        node.next = self._head
        back.next = node
        self._head.prev = node
        self._length += 1
        return node

    def peek(self):
        if self._length == 0:
            return None
        assert self._head.next is not None
        return self._head.next.value

    def shift(self):
        """Pop from the front; returns the value (None if empty)."""
        if self._length == 0:
            return None
        node = self._head.next
        assert node is not None
        node.remove()
        return node.value

    def __iter__(self) -> typing.Iterator:
        """Iterate over a snapshot of the nodes present at iteration start,
        skipping any removed mid-iteration. (Hardening over the reference's
        forEach, lib/queue.js:66-73, which breaks if a callback removes the
        next node.)"""
        nodes = []
        node = self._head.next
        while node is not self._head:
            assert node is not None
            nodes.append(node)
            node = node.next
        for n in nodes:
            if n.is_queued():
                yield n.value

    def for_each(self, fn: typing.Callable) -> None:
        for v in self:
            fn(v)
