"""cueball_tpu_torch: the fleet runtime in PyTorch, on CUDA, with its own
connection-pool layer.

The counterpart of the JAX package ``cueball_tpu``'s batched control
laws (``ops``) and its live fleet runtime (``parallel``: the telemetry,
control and health steps and the ``FleetSampler`` that drives them, on
one device or split over a ``Mesh`` of devices in one process),
written in PyTorch, with the FIR matvec as a hand-written CUDA kernel
for Hopper (``csrc/fir.cu``); and a copy of that package's asyncio pool
and service-discovery layer (``ConnectionPool``, ``ConnectionSet``,
``DNSResolver`` with its DNS client, ``StaticIpResolver``,
``HttpAgent``, the slot and resolver FSMs, the claim tracer, the
claim-path profiler, the wire ledger, the SIGUSR2 debug dump, the kang
debug server, the shard router (``shard.FleetRouter``), the
``cbresolve`` command (``python -m cueball_tpu_torch.cli``) and the
``netsim`` simulator), whose pools the sampler samples and whose pools
act on the control step's decisions. It imports nothing of
``cueball_tpu``.

Entry points run on the CUDA card unless the caller passes
``device='cpu'``; without a card the default raises. Importing the
package builds no kernel: ``kernels.build`` runs nvcc on first use.
``cueball_tpu_torch.entry`` holds the entry point
``entry(device=None)`` and its seeded inputs.
"""

from .agent import HttpAgent, HttpsAgent
from .codel import ControlledDelay
from .cqueue import Queue
from .cset import ConnectionSet
from .debug import (LoopAffinityChecker, dump_fsm_histories,
                    init_from_env as _debug_init_from_env,
                    install_debug_handler)
from .errors import (ClaimHandleMisusedError, ClaimTimeoutError,
                     ConnectionClosedError, ConnectionError,
                     ConnectionTimeoutError, NoBackendsError,
                     PoolFailedError, PoolStoppingError,
                     TransportNotAvailableError)
from .events import EventEmitter
from .fsm import FSM
from .monitor import pool_monitor
from .pool import ConnectionPool
from .resolver import (DNSResolver, Resolver, ResolverFSM,
                       StaticIpResolver, config_for_ip_or_domain,
                       resolver_for_ip_or_domain)
from .trace import disable_tracing, enable_tracing, trace_ring, tracing_enabled
from .transport import (AsyncioTransport, FabricTransport, NativeTransport,
                        Transport, get_transport, register_transport)
from .utils import (current_millis, enable_stack_traces, plan_rebalance,
                    stack_traces_enabled)
from .ops import (CodelState, backoff_schedule, codel_scan, fir_apply,
                  fir_apply_cuda, fir_smooth, gen_taps, spread_delays)
from .parallel import (FleetInputs, FleetSampler, FleetState, fleet_init,
                       fleet_inputs, fleet_scan, fleet_step,
                       fleet_step_cuda, fleet_step_plain, make_live_step,
                       rebase_state)

# Live-attach diagnostics: CUEBALL_STACK_TRACES=1 enables claim stack
# capture at startup; CUEBALL_DEBUG_SIGNAL=1 (or a signal name)
# installs a handler that toggles capture and dumps all FSM histories
# on each delivery.
_debug_init_from_env()

# The JAX package's camelCase aliases of the reference's export names.
resolverForIpOrDomain = resolver_for_ip_or_domain
configForIpOrDomain = config_for_ip_or_domain
poolMonitor = pool_monitor
enableStackTraces = enable_stack_traces

__all__ = ['CodelState', 'FleetInputs', 'FleetSampler', 'FleetState',
           'backoff_schedule', 'codel_scan', 'fir_apply', 'fir_apply_cuda',
           'fir_smooth', 'fleet_init', 'fleet_inputs', 'fleet_scan',
           'fleet_step', 'fleet_step_cuda', 'fleet_step_plain', 'gen_taps',
           'make_live_step', 'rebase_state', 'spread_delays',
           'ConnectionPool', 'ConnectionSet',
           'Resolver', 'DNSResolver', 'StaticIpResolver', 'ResolverFSM',
           'resolver_for_ip_or_domain', 'config_for_ip_or_domain',
           'resolverForIpOrDomain', 'configForIpOrDomain',
           'HttpAgent', 'HttpsAgent',
           'pool_monitor', 'poolMonitor', 'enableStackTraces',
           'dump_fsm_histories', 'install_debug_handler',
           'LoopAffinityChecker',
           'enable_tracing', 'disable_tracing', 'tracing_enabled',
           'trace_ring',
           'Transport', 'AsyncioTransport', 'FabricTransport',
           'NativeTransport', 'get_transport', 'register_transport',
           'EventEmitter', 'FSM', 'Queue', 'ControlledDelay',
           'enable_stack_traces', 'stack_traces_enabled', 'current_millis',
           'plan_rebalance',
           'ClaimHandleMisusedError', 'ClaimTimeoutError', 'NoBackendsError',
           'PoolFailedError', 'PoolStoppingError', 'ConnectionError',
           'ConnectionTimeoutError', 'ConnectionClosedError',
           'TransportNotAvailableError']


def api_modules() -> list:
    """The port's public modules: this package and every module under it
    but the private ones (a name part starting with ``_``).
    ``docs/torch_api.md`` names every public name of each
    (``tests/test_torch_docs.py``)."""
    import pkgutil
    return [__name__] + [
        m.name for m in pkgutil.walk_packages(__path__, __name__ + '.')
        if not any(part.startswith('_') for part in m.name.split('.'))]
