"""Error hierarchy with VError-style cause chaining.

Rebuild of reference `lib/errors.js:9-112`. Every class carries the
contextual objects (pool, backend) and a cause chain; messages embed the
pool uuid/domain or backend host:port the way the reference does so that
operator logs stay greppable. Cause chaining uses Python's native
``__cause__`` plus a ``cause()`` accessor mirroring VError.
"""

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

    def full_message(self) -> str:
        """Message with the cause chain appended, VError-style."""
        msg = str(self)
        c = self.__cause__
        while c is not None:
            msg += ': ' + str(c)
            c = getattr(c, '__cause__', None)
        return msg


class ClaimHandleMisusedError(CueBallError):
    """User treated a claim handle as if it were the connection
    (reference lib/errors.js:26-35)."""

    def __init__(self):
        super().__init__(
            'CueBall claim handle used as if it was a socket (check the '
            'order and number of arguments in your claim callbacks)')


class ClaimTimeoutError(CueBallError):
    """Claim sat in the wait queue past its timeout
    (reference lib/errors.js:37-47)."""

    def __init__(self, pool):
        self.pool = pool
        super().__init__(
            'Timed out while waiting for connection in pool %s (%s)' % (
                pool.p_uuid, pool.p_domain))


class NoBackendsError(CueBallError):
    """Claim made while the resolver has produced no backends
    (reference lib/errors.js:49-58)."""

    def __init__(self, pool, cause: 'BaseException | None' = None):
        self.pool = pool
        super().__init__(
            'No backends available in pool %s (%s)' % (
                pool.p_uuid, pool.p_domain), cause)


class PoolFailedError(CueBallError):
    """Pool is in the failed state: all backends declared dead
    (reference lib/errors.js:60-75)."""

    def __init__(self, pool, cause: 'BaseException | None' = None):
        self.pool = pool
        dead = len(pool.p_dead)
        avail = len(pool.p_keys)
        super().__init__(
            'Connections to backends of pool %s (%s) are persistently '
            'failing; request aborted (%d of %d declared dead, in state '
            '"failed")' % (pool.p_uuid.split('-')[0], pool.p_domain,
                           dead, avail), cause)


class PoolStoppingError(CueBallError):
    """Claim made on a stopping/stopped pool
    (reference lib/errors.js:77-87)."""

    def __init__(self, pool):
        self.pool = pool
        super().__init__(
            'Pool %s (%s) is stopping and cannot take new requests' % (
                pool.p_uuid.split('-')[0], pool.p_domain))


class ConnectionError(CueBallError):
    """Connection emitted 'error' (reference lib/errors.js:89-101).

    Named for parity with the reference API; unrelated to (and does not
    catch) Python's builtin OSError-based ConnectionError.
    """

    def __init__(self, backend: dict, event: str, state: str,
                 cause: 'BaseException | None' = None):
        self.backend = backend
        super().__init__(
            'Connection to backend %s (%s:%s) emitted "%s" during %s' % (
                backend.get('name') or backend.get('key'),
                backend.get('address'), backend.get('port'),
                event, state), cause)


class ConnectionTimeoutError(CueBallError):
    """Connect attempt exceeded its timeout
    (reference lib/errors.js:103-112)."""

    def __init__(self, backend: dict):
        self.backend = backend
        super().__init__(
            'Connection timed out to backend %s (%s:%s)' % (
                backend.get('name') or backend.get('key'),
                backend.get('address'), backend.get('port')))


class ConnectionClosedError(CueBallError):
    """Connection closed unexpectedly (reference lib/errors.js:114-123)."""

    def __init__(self, backend: dict):
        self.backend = backend
        super().__init__(
            'Connection closed unexpectedly to backend %s (%s:%s)' % (
                backend.get('name') or backend.get('key'),
                backend.get('address'), backend.get('port')))


class TransportNotAvailableError(CueBallError):
    """A transport backend is registered but its data path is not
    built in this process (the ``native`` stub until native/transport
    lands). Carries the seam that was asked for — ``'resolve'`` when
    ``get_transport`` refused the backend at resolution time, else one
    of the five seam method names — so callers and logs can tell a
    missing build from a miswired call site."""

    def __init__(self, seam: str, transport: str = 'native',
                 cause: 'BaseException | None' = None):
        self.seam = seam
        self.transport = transport
        super().__init__(
            "transport %r is not available (seam %r): the data path "
            "is not built in this process; register a real factory "
            "via register_transport(%r, ...)" % (transport, seam,
                                                 transport), cause)


class ShardDeadError(CueBallError):
    """A FleetRouter call was routed to a shard whose event loop is no
    longer running (loop stopped, thread exited, or child process
    died). Claims and submits against pools owned by that shard fail
    fast with this error instead of deadlocking on a loop that will
    never pump; the router re-homes the pools when the shard is
    restarted."""

    def __init__(self, shard_id: int, detail: str = '',
                 cause: 'BaseException | None' = None):
        self.shard_id = shard_id
        msg = 'Shard %r event loop is not running' % (shard_id,)
        if detail:
            msg += ' (%s)' % detail
        super().__init__(msg, cause)
