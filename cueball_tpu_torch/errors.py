"""The port's copy of the JAX package's error base,
``cueball_tpu.errors.CueBallError``: the fleet passes of
``shard.FleetRuntime`` raise it where that package's router does."""

from __future__ import annotations


class CueBallError(Exception):
    """Base for all framework errors; supports cause chaining."""

    def __init__(self, message: str, cause: 'BaseException | None' = None):
        super().__init__(message)
        # Only assign when a cause exists: setting __cause__ (even to
        # None) flips __suppress_context__ and would hide the implicit
        # exception context from tracebacks.
        if cause is not None:
            self.__cause__ = cause

    def cause(self) -> 'BaseException | None':
        return self.__cause__
