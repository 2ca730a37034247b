"""The fleet passes of a sharded router: the counterpart of the JAX
package's ``FleetRouter.sample_fleet``, ``control_fleet`` and
``health_fleet`` (``shard/router.py:478-558``, ``:622-638``) and of the
health part of its ``snapshot()`` (``:434-443``).

A :class:`FleetRuntime` keeps one port ``FleetSampler`` per router
shard and ticks each on its own shard's loop, so the sampler's row
columns, its pools' hooks and the control step's actuation stay on the
loop that owns those pools. This package's :class:`~.router.FleetRouter`
runs its passes through one, whose samplers are the router's
``fr_samplers``. The router is duck-typed: it needs ``fr_backend``,
``fr_fsms[sid].is_in_state('running')``, ``fr_workers[sid].run(job,
*args)`` (awaitable; the sample pass uses it, as the JAX router does,
without counting a submit) and ``run_on(sid, job, *args)`` (awaitable;
the control and health passes). So a runtime also runs over
``entry.ShardedWorkload``, synthetic pools on this package's own
``ThreadWorker`` shards, each with its ``ShardFSM``, and over the JAX
package's thread or inline router in the tests.

A pass awaits the shards' jobs one after another, as the JAX router
does (``router.py:516-521``, ``:631-636``), and raises the first
failure.

Tracing. Three ``torch.profiler.record_function`` ranges mark a pass:
:data:`PASS_RANGE` on the router's loop around the whole pass,
:data:`JOB_RANGE` on the shard's loop around each shard's job, and
:data:`REDUCE_RANGE` around the shard -> host reduction. (A profiler
records another thread's ranges only when it traces every thread.)
The runtime also counts, for the router's metrics, the passes run by
kind (``rt_passes``) and, per shard, the milliseconds of its jobs
(``rt_job_ms``) and of its hops (``rt_hop_ms``): from the submit on the
router's loop to the job's start, plus from the job's end to the
router's loop resuming.
"""

from __future__ import annotations

import collections

from torch.profiler import record_function

from .. import utils
from ..errors import CueBallError
from ..parallel.control import reduce_control
from ..parallel.health import reduce_health
from ..parallel.sampler import FleetSampler, reduce_fleet

PASS_RANGE = 'cueball.router.pass'
JOB_RANGE = 'cueball.router.shard_job'
REDUCE_RANGE = 'cueball.router.reduce'

_SPAWN_REFUSALS = {
    'sample_fleet': 'sample_fleet is not available on the spawn backend; '
                    'children publish their own collectors',
    'control_fleet': 'control_fleet is not available on the spawn '
                     'backend; children run their own control planes',
    'health_fleet': 'health_fleet is not available on the spawn backend; '
                    'children run their own health monitors',
}


class FleetRuntime:
    """Per-shard port samplers over a router's shards.

    ``options`` go to every shard's ``FleetSampler`` with ``shard`` set
    to the shard id: ``monitor`` (default this package's pool monitor;
    a deployment of the JAX package's pools passes that package's),
    ``host`` (there, ``host.seam_over(...)``), ``device`` (default CUDA,
    which must exist), ``objectives``, ``interval``, ``control``,
    ``health``, ``mesh``. As on the JAX router, a shard's sampler is
    made by its first pass, and a control or health pass turns that
    plane on for good."""

    def __init__(self, router, options: dict | None = None):
        self.rt_router = router
        self.rt_options = dict(options or {})
        self.rt_samplers: dict[int, FleetSampler] = {}
        self.rt_passes: collections.Counter = collections.Counter()
        self.rt_job_ms: dict[int, float] = {}
        self.rt_hop_ms: dict[int, float] = {}

    # -- per-shard jobs (each runs on its shard's loop) -----------------

    def _sampler(self, shard_id: int, plane: str | None = None):
        sampler = self.rt_samplers.get(shard_id)
        if sampler is None:
            opts = dict(self.rt_options, shard=shard_id)
            if plane is not None:
                opts[plane] = True
            sampler = FleetSampler(opts)
            self.rt_samplers[shard_id] = sampler
        elif plane is not None:
            setattr(sampler, 'fs_' + plane, True)
        return sampler

    def _sample_shard(self, shard_id: int) -> dict:
        return self._sampler(shard_id).sample_once()['fleet']

    def _control_shard(self, shard_id: int) -> dict:
        # The actuation (apply_decisions on each owned pool) happens in
        # this tick, on the loop that owns those pools.
        return self._sampler(shard_id, 'control').sample_once()['control']

    def _health_shard(self, shard_id: int) -> dict:
        return self._sampler(shard_id, 'health').sample_once()['health']

    # -- passes ----------------------------------------------------------

    def _running(self) -> list:
        return [sid for sid, fsm in sorted(self.rt_router.fr_fsms.items())
                if fsm.is_in_state('running')]

    @staticmethod
    def _timed(job, shard_id: int) -> tuple:
        """Run on the shard's loop: ``job(shard_id)`` in its range, with
        its start and end on the host's monotonic clock."""
        with record_function(JOB_RANGE):
            start = utils.perf_seconds()
            record = job(shard_id)
            end = utils.perf_seconds()
        return record, start, end

    async def _pass(self, name: str, run, job, reduce):
        """Run ``job`` on each running shard in turn, through ``run(sid,
        fn, *args)`` (awaitable), and reduce the shards' records in
        shard order. A shard's failure, or a shard that returns no
        record, fails the pass."""
        if self.rt_router.fr_backend == 'spawn':
            raise CueBallError(_SPAWN_REFUSALS[name])
        with record_function(PASS_RANGE):
            records = []
            for sid in self._running():
                submit = utils.perf_seconds()
                rec, start, end = await run(sid, self._timed, job, sid)
                resumed = utils.perf_seconds()
                self.rt_job_ms[sid] = (self.rt_job_ms.get(sid, 0.0)
                                       + (end - start) * 1e3)
                self.rt_hop_ms[sid] = (self.rt_hop_ms.get(sid, 0.0)
                                       + (start - submit + resumed - end)
                                       * 1e3)
                if rec is None:
                    raise CueBallError('%s: shard %d returned no record'
                                       % (name, sid))
                records.append(rec)
            with record_function(REDUCE_RANGE):
                out = reduce(records)
        self.rt_passes[name.partition('_')[0]] += 1
        return out

    def _run_worker(self, sid: int, fn, *args):
        # The sample pass counts no submit, as the JAX router's.
        return self.rt_router.fr_workers[sid].run(fn, *args)

    def _run_on(self, sid: int, fn, *args):
        return self.rt_router.run_on(sid, fn, *args)

    async def sample_fleet(self, mesh=None, mesh_axes=('host', 'chip')):
        """One sampler tick on every running shard, then the shard ->
        host reduction (and host -> mesh when ``mesh`` is given)."""
        return await self._pass(
            'sample_fleet', self._run_worker, self._sample_shard,
            lambda records: reduce_fleet(records, mesh=mesh,
                                         mesh_axes=mesh_axes))

    async def control_fleet(self) -> dict:
        """One control-plane pass: each running shard's sampler ticks
        with control on and applies its decisions on its own loop; the
        per-shard summaries reduce shard -> host."""
        return await self._pass('control_fleet', self._run_on,
                                self._control_shard, reduce_control)

    async def health_fleet(self) -> dict:
        """One health pass: each running shard's sampler ticks with
        health on; the verdict records merge with ``reduce_health``
        (gray sets union, burn rates take the worst shard)."""
        return await self._pass('health_fleet', self._run_on,
                                self._health_shard, reduce_health)

    def health_snapshot(self) -> dict | None:
        """The merged verdicts of the shards whose sampler runs the
        health plane (the router snapshot's ``health``), or None when
        none has judged yet. Reading ``hm_last`` cross-thread is safe:
        a tick rebinds the record, never mutates it."""
        verdicts = [s.fs_health_monitor.hm_last
                    for s in list(self.rt_samplers.values())
                    if s.fs_health_monitor is not None]
        if not any(v is not None for v in verdicts):
            return None
        return reduce_health(verdicts)

    async def stop(self) -> None:
        """Stop every shard's sampler on its own loop (inline for a
        shard that no longer runs) and forget them."""
        router = self.rt_router
        samplers = sorted(self.rt_samplers.items())
        self.rt_samplers.clear()      # the router's fr_samplers too
        for sid, sampler in samplers:
            fsm = router.fr_fsms.get(sid)
            if fsm is not None and fsm.is_in_state('running'):
                await router.fr_workers[sid].run(sampler.stop)
            else:
                sampler.stop()
