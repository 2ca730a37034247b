"""The simulated data plane: links, connections, fault schedules.

A ``Fabric`` stands in for the network between a pool and its
backends. ``fabric.constructor`` plugs straight into the pool/cset
``options['constructor']`` seam; each call yields a ``SimConnection``
whose connect handshake and failure behavior follow the backend's
``LinkModel`` — latency/jitter, probabilistic connect loss,
connect-hang, RST-on-accept, slow-loris handshakes — on virtual
timers, with every random draw from the fabric's injected rng.

Fault schedules mutate fabric state mid-run:

- ``partition(keys)`` / ``heal(keys)`` — full partition: new connects
  hang (SYN blackholed) and established connections die. Asymmetric
  variant (``kill_established=False``): the return path is lost so
  new handshakes hang, but established flows keep working — the
  classic gray middlebox.
- ``down(key)`` / ``up(key)`` — a backend process restarting: RST on
  connect, established connections reset. ``rolling_restart``
  schedules this across the fleet one backend at a time.
- ``set_gray(fraction, mult)`` — N% of backends turn 100x slow
  without failing: connects still succeed, service times stretch.

Nothing here touches pool/cset/FSM code: the fabric only speaks the
connection contract (connect/error/close events + destroy/ref/unref)
defined by connection_fsm. See docs/netsim.md.
"""

from __future__ import annotations

from .. import utils as mod_utils
from .. import wiretap as mod_wiretap
from ..events import EventEmitter
from ..fsm import get_loop


class LinkModel:
    """Per-backend network behavior. ``connect`` is one of 'ok',
    'hang', 'rst', 'slow' (slow-loris: the handshake dribbles out and
    completes only after ``slow_s``). ``loss`` is the probability a
    connect attempt dies with a reset after the latency. ``service``
    is the base request service time; ``service_mult`` stretches it
    for gray-failure modeling."""

    def __init__(self, latency_ms: float = 1.0, jitter_ms: float = 0.0,
                 loss: float = 0.0, connect: str = 'ok',
                 slow_s: float = 300.0, service_ms: float = 1.0,
                 service_mult: float = 1.0, trickle_segments: int = 0,
                 trickle_ms: float = 5.0):
        self.latency_ms = latency_ms
        self.jitter_ms = jitter_ms
        self.loss = loss
        self.connect = connect
        self.slow_s = slow_s
        self.service_ms = service_ms
        self.service_mult = service_mult
        # Claim-handshake trickle: the peer dribbles the claim-time
        # handshake out in `trickle_segments` segments of `trickle_ms`
        # each (SimConnection.cb_claim_ready), modeling a middlebox
        # that fragments and delays segments mid-handshake without
        # failing the connection.
        self.trickle_segments = trickle_segments
        self.trickle_ms = trickle_ms

    def delay_s(self, rng) -> float:
        d = self.latency_ms
        if self.jitter_ms > 0:
            d += rng.random() * self.jitter_ms
        return d / 1000.0


class ConnectionResetError2(Exception):
    """RST from the simulated peer (name avoids shadowing the
    builtin ConnectionResetError, which some call sites catch)."""


class SimConnection(EventEmitter):
    """One simulated TCP connection, driven entirely by virtual
    timers. Emits 'connect' / 'error' / 'close' per the slot-FSM
    contract; ``request()`` models one unit of application work at
    the link's (possibly gray-stretched) service time."""

    def __init__(self, fabric: 'Fabric', backend: dict):
        super().__init__()
        self.fabric = fabric
        self.backend = backend
        self.key = backend.get('key') or '%s:%s' % (
            backend.get('address'), backend.get('port'))
        # Alias key: pools hand the constructor THEIR hashed backend
        # key, so fabric config/faults may instead name backends by
        # 'address:port' — both resolve.
        self.akey = ('%s:%s' % (backend['address'],
                                backend.get('port'))
                     if backend.get('address') is not None else None)
        self.connected = False
        self.dead = False
        self.refd = True
        self._timer = None
        # The claim-readiness probe is bound as an INSTANCE attribute,
        # and only when this connection's link actually trickles: the
        # slot FSM probes via getattr on every single claim, so a
        # class-level method would tax the hot path of every netsim
        # soak (~14us/claim) for a fault mode almost no run uses.
        # Consequence: trickle config must be in place before the
        # connection is created — links mutated afterwards affect
        # only connections made from then on, like every other
        # connect-time link property.
        lm = fabric._links.get(self.key)
        if lm is None and self.akey is not None:
            lm = fabric._links.get(self.akey)
        if lm is not None and lm.trickle_segments:
            self.cb_claim_ready = self._cb_claim_ready
        fabric._register(self)
        self._schedule_handshake()

    # -- handshake ------------------------------------------------------

    def _schedule_handshake(self) -> None:
        link = self.fabric.link_for(self)
        rng = self.fabric.rng
        if self.fabric._conn_in(self, self.fabric._partitioned) or \
                link.connect == 'hang':
            return          # SYN into the void; pool timeout decides
        delay = link.delay_s(rng)
        if link.connect == 'rst' or \
                self.fabric._conn_in(self, self.fabric._down):
            self._timer = get_loop().call_later(
                delay, self._fail,
                ConnectionResetError2('connection refused by %s'
                                      % self.key))
            return
        if link.connect == 'slow':
            delay += link.slow_s
        elif link.loss > 0 and rng.random() < link.loss:
            self._timer = get_loop().call_later(
                delay, self._fail,
                ConnectionResetError2('connect lost to %s' % self.key))
            return
        self._timer = get_loop().call_later(delay, self._complete)

    # Ledger label connection_fsm stamps wire records with
    # (TcpStreamConnection carries its transport's name the same way).
    wt_transport = 'fabric'

    # Wire marks for the wiretap socket_wait decomposition: class
    # default None (no handshake completed); _complete stamps
    # (ready, dispatched) with ready == dispatched — a virtual link
    # has no loop-dispatch gap, the whole connect latency is
    # kernel_wait, which is what keeps the asyncio/fabric ledgers
    # comparable.
    wt_marks = None

    def _complete(self) -> None:
        if self.dead:
            return
        self.connected = True
        if mod_wiretap.wiretap_enabled():
            now = mod_utils.current_millis()
            self.wt_marks = (now, now)
        self.emit('connect')

    def _fail(self, err) -> None:
        if self.dead:
            return
        self.connected = False
        self.emit('error', err)

    # -- connection contract --------------------------------------------

    def ref(self) -> None:
        self.refd = True

    def unref(self) -> None:
        self.refd = False

    def destroy(self) -> None:
        if self.dead:
            return
        self.dead = True
        self.connected = False
        if self._timer is not None:
            self._timer.cancel()
        self.fabric._unregister(self)
        self.emit('close')

    # -- claim-readiness probe --------------------------------------------

    def _cb_claim_ready(self, done) -> None:
        """Transport claim-readiness probe (connection_fsm state_busy
        seam), bound to ``cb_claim_ready`` at construction when the
        link trickles. With ``trickle_segments`` configured, the
        claim-time handshake dribbles out in N virtual segments of
        ``trickle_ms`` each before completing — the middlebox that
        fragments and delays segments mid-handshake without failing
        the connection. Without trickle, ``done(True)`` fires
        synchronously, byte-identical to the plain accept path."""
        if self.dead or not self.connected:
            done(False)
            return
        link = self.fabric.link_for(self)
        segments = int(link.trickle_segments or 0)
        if segments <= 0:
            done(True)
            return

        # Wire accounting: the dribbled handshake is time spent
        # waiting on the (virtual) kernel, not parsing — when wiretap
        # is on, the elapsed probe time lands in the fabric
        # transport's kernel_wait total. The claim-ledger PHASES view
        # is unchanged (the probe runs inside the handshake phase).
        if mod_wiretap.wiretap_enabled():
            probe_start = mod_utils.current_millis()
            inner_done = done

            def done(ok, _inner=inner_done, _t0=probe_start):
                mod_wiretap.wire_wait(
                    'fabric', mod_utils.current_millis() - _t0)
                _inner(ok)

        def step(k):
            if self.dead or not self.connected:
                done(False)
                return
            if k >= segments:
                done(True)
                return
            self._timer = get_loop().call_later(
                link.trickle_ms / 1000.0, step, k + 1)

        step(0)

    # -- application work ------------------------------------------------

    def service_time_s(self) -> float:
        link = self.fabric.link_for(self)
        base = link.service_ms * link.service_mult
        if link.jitter_ms > 0:
            base += self.fabric.rng.random() * link.jitter_ms
        return base / 1000.0

    async def request(self) -> None:
        """One request-response at the link's current service time."""
        import asyncio
        await asyncio.sleep(self.service_time_s())


class ManualConnection(SimConnection):
    """SimConnection whose handshake the TEST drives: nothing happens
    until connect()/emit is called, the tests/fakes.py DummyConnection
    contract, now with fabric registration so fault schedules can
    reach manually-driven connections too."""

    def _schedule_handshake(self) -> None:
        pass

    def connect(self) -> None:
        assert self.dead is False
        self._complete()


class Fabric:
    """The simulated network: per-backend links, live-connection
    registry, and the fault-schedule API."""

    def __init__(self, rng=None):
        self._rng = rng
        self.default_link_args: dict = {}
        self._links: dict[str, LinkModel] = {}
        self._partitioned: set[str] = set()
        self._down: set[str] = set()
        self._conns: dict[str, list[SimConnection]] = {}
        self.connection_class = SimConnection

    @property
    def rng(self):
        """Resolved at DRAW time, not construction time: fabrics are
        typically built before Scenario.run installs the seeded rng
        seam, and capturing early would silently break replay."""
        if self._rng is not None:
            return self._rng
        from .. import utils as mod_utils
        return mod_utils.get_rng()

    # -- link config -----------------------------------------------------

    def link(self, key: str) -> LinkModel:
        lm = self._links.get(key)
        if lm is None:
            lm = LinkModel(**self.default_link_args)
            self._links[key] = lm
        return lm

    def link_for(self, conn: SimConnection) -> LinkModel:
        """Resolve a connection's link: its backend key first, then
        its 'address:port' alias, else lazily create a default."""
        lm = self._links.get(conn.key)
        if lm is None and conn.akey is not None:
            lm = self._links.get(conn.akey)
        return lm if lm is not None else self.link(conn.key)

    def set_link(self, key: str, **kwargs) -> LinkModel:
        """``key`` is either the backend dict's 'key' or the
        'address:port' alias — connections resolve both."""
        lm = LinkModel(**dict(self.default_link_args, **kwargs))
        self._links[key] = lm
        return lm

    # -- constructor seam -------------------------------------------------

    def constructor(self, backend: dict) -> SimConnection:
        """Pass ``fabric.constructor`` as options['constructor']."""
        return self.connection_class(self, backend)

    def _register(self, conn: SimConnection) -> None:
        self._conns.setdefault(conn.key, []).append(conn)

    def _unregister(self, conn: SimConnection) -> None:
        lst = self._conns.get(conn.key)
        if lst and conn in lst:
            lst.remove(conn)

    def connections(self, key: str | None = None) \
            -> list[SimConnection]:
        if key is not None:
            out = list(self._conns.get(key) or [])
            for k, lst in self._conns.items():
                if k != key:
                    out.extend(c for c in lst if c.akey == key)
            return out
        return [c for lst in self._conns.values() for c in lst]

    # -- fault schedule ----------------------------------------------------

    @staticmethod
    def _conn_in(conn: SimConnection, keyset: set) -> bool:
        return conn.key in keyset or (conn.akey is not None
                                      and conn.akey in keyset)

    def is_partitioned(self, key: str) -> bool:
        return key in self._partitioned

    def is_down(self, key: str) -> bool:
        return key in self._down

    def _kill(self, key: str, err) -> None:
        for conn in self.connections(key):
            conn._fail(err)

    def partition(self, keys, kill_established: bool = True) -> None:
        """Full partition: new connects hang. With
        ``kill_established=False`` this is the asymmetric case —
        established flows survive, new handshakes blackhole."""
        for key in keys:
            self._partitioned.add(key)
            if kill_established:
                self._kill(key, ConnectionResetError2(
                    'partition severed %s' % key))

    def heal(self, keys=None) -> None:
        if keys is None:
            self._partitioned.clear()
        else:
            self._partitioned.difference_update(keys)

    def down(self, key: str) -> None:
        """Backend process stops: RST on connect, established reset."""
        self._down.add(key)
        self._kill(key, ConnectionResetError2(
            'connection reset: %s went down' % key))

    def up(self, key: str) -> None:
        self._down.discard(key)

    def set_gray(self, keys, mult: float = 100.0) -> list[str]:
        """Stretch service times on ``keys`` (a list, or a float
        fraction of all known links chosen by the fabric rng) by
        ``mult`` without failing anything — gray failure. Returns the
        affected keys."""
        if isinstance(keys, float):
            pool = sorted(self._links)
            count = max(1, round(len(pool) * keys))
            keys = self.rng.sample(pool, count)
        for key in keys:
            self.link(key).service_mult = mult
        return list(keys)

    def clear_gray(self) -> None:
        for lm in self._links.values():
            lm.service_mult = 1.0
