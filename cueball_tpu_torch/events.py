"""Synchronous event emitter.

The reference is built on Node's EventEmitter contract: synchronous
delivery in registration order, `once` auto-removal, listener
introspection for the claim-handle leak detector
(reference lib/connection-fsm.js:786-808 counts listeners by function
identity). This is a minimal faithful equivalent for asyncio programs;
emission is synchronous, scheduling is the caller's concern.

This package's copy of ``cueball_tpu.events``, with the pure-Python
emitter only: ``_native`` is None (the C core of ``native/`` is not
part of this package yet), so every module that branches on it takes
its pure path.
"""

from __future__ import annotations

import typing

_native = None


class PyEventEmitter:
    """Node-style event emitter with synchronous delivery (the
    pure-Python implementation, which the JAX package's C core in
    native/emitter.c mirrors exactly)."""

    def __init__(self) -> None:
        self._ee_listeners: dict[str, list] = {}
        # External-listener mutation epoch: bumped on every add/remove
        # of a non-framework listener (FSM gates are marked
        # `_cueball_internal`). The claim-handle leak detector skips
        # its per-event count sweep while the epoch is unchanged; the
        # C core keeps the same counter (emitter.c ee_mutations).
        self._ee_mut = 0

    # -- registration ----------------------------------------------------

    def on(self, event: str, listener: typing.Callable) -> typing.Callable:
        """Register listener; returns it so callers can hold a removal ref."""
        self._ee_listeners.setdefault(event, []).append(listener)
        if not getattr(listener, '_cueball_internal', False):
            self._ee_mut += 1
        return listener

    add_listener = on

    def once(self, event: str, listener: typing.Callable) -> typing.Callable:
        def wrapper(*args, **kwargs):
            self.remove_listener(event, wrapper)
            return listener(*args, **kwargs)
        wrapper.__wrapped_listener__ = listener
        self.on(event, wrapper)
        return wrapper

    def remove_listener(self, event: str, listener: typing.Callable) -> None:
        lst = self._ee_listeners.get(event)
        if not lst:
            return
        # Identity scan first (the overwhelmingly common case on the
        # claim hot path); fall back to the once()-wrapper scan.
        for i, entry in enumerate(lst):
            if entry is listener:
                if not getattr(entry, '_cueball_internal', False):
                    self._ee_mut += 1
                del lst[i]
                break
        else:
            for i, entry in enumerate(lst):
                if getattr(entry, '__wrapped_listener__', None) is listener:
                    if not getattr(entry, '_cueball_internal', False):
                        self._ee_mut += 1
                    del lst[i]
                    break
        if not lst:
            self._ee_listeners.pop(event, None)

    def remove_all_listeners(self, event: str | None = None) -> None:
        # Conservative bump (may not have removed anything external):
        # a spurious bump only costs the leak detector one extra sweep.
        self._ee_mut += 1
        if event is None:
            self._ee_listeners.clear()
        else:
            self._ee_listeners.pop(event, None)

    # -- introspection ---------------------------------------------------

    def listeners(self, event: str) -> list:
        return list(self._ee_listeners.get(event, ()))

    def listener_count(self, event: str) -> int:
        return len(self._ee_listeners.get(event, ()))

    def event_names(self) -> list[str]:
        return [k for k, v in self._ee_listeners.items() if v]

    def mutation_count(self) -> int:
        """External-listener mutation epoch (see __init__)."""
        return self._ee_mut

    # -- emission --------------------------------------------------------

    def emit(self, event: str, *args) -> bool:
        """Deliver synchronously to a snapshot of current listeners.

        Returns True if anyone was listening (Node contract; the Set's
        assert_emit crash-if-unhandled check relies on this,
        reference lib/set.js:471-479).
        """
        lst = self._ee_listeners.get(event)
        if not lst:
            return False
        if len(lst) == 1:
            # Fast path: a lone listener that unsubscribes mid-call has
            # already run, so no snapshot copy is needed.
            lst[0](*args)
        else:
            for listener in tuple(lst):
                listener(*args)
        return True


EventEmitter = PyEventEmitter if _native is None else _native.EventEmitter
