"""The synchronous event emitter subset the fleet sampler uses: the
counterpart of ``cueball_tpu.events.EventEmitter`` for ``on``,
``emit`` and ``remove_listener`` (Node's contract: synchronous
delivery in registration order)."""

from __future__ import annotations

import typing


class EventEmitter:
    def __init__(self) -> None:
        self._ee_listeners: dict[str, list] = {}

    def on(self, event: str, listener: typing.Callable) -> typing.Callable:
        """Register listener; returns it so callers can hold a removal
        ref."""
        self._ee_listeners.setdefault(event, []).append(listener)
        return listener

    def remove_listener(self, event: str, listener: typing.Callable) -> None:
        lst = self._ee_listeners.get(event)
        if not lst:
            return
        for i, entry in enumerate(lst):
            if entry is listener:
                del lst[i]
                break
        if not lst:
            self._ee_listeners.pop(event, None)

    def emit(self, event: str, *args) -> bool:
        """Deliver synchronously to a snapshot of the current listeners;
        True if anyone was listening."""
        lst = self._ee_listeners.get(event)
        if not lst:
            return False
        for listener in tuple(lst):
            listener(*args)
        return True
