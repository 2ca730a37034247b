"""Deterministic hostile-network simulator (ROADMAP item 4).

A seeded, virtual-time network fabric that plugs in UNDER the
framework's seams — ``options['constructor']``, ``options['resolver']``
/ ``options['dnsClient']``, and the ``dns_client.DnsTransport`` wire
seam — without touching pool/cset/FSM code. One seed determines a
whole run: the virtual clock (``netsim.clock``) drives every timer,
the injected rng (``utils.set_rng``) feeds every random draw, and the
FSM transition trace is byte-identical across replays.

    from cueball_tpu_torch import netsim

    fabric = netsim.Fabric()
    sc = netsim.Scenario('regional-failover', seed=7)
    sc.at(5.0, 'partition', lambda: fabric.partition(['b1', 'b2']))
    sc.at(9.0, 'heal', lambda: fabric.heal())
    sc.run(main)          # main() -> coroutine using the fabric

See docs/netsim.md for the architecture and the scenario-writing
guide; the corpus lives in tests/scenarios/.
"""

from .clock import (LoopStarvedError, VIRTUAL_EPOCH, VirtualClock,
                    VirtualLoop, run)
from .dns import (CHAOS_BANDS, ChaosDnsClient, DnsOutcome,
                  ScriptedDnsClient, SimWire, SimZone, encode_response,
                  parse_query)
from .fabric import (ConnectionResetError2, Fabric, LinkModel,
                     ManualConnection, SimConnection)
from .scenario import (Scenario, herd, jain_index, quantile,
                       success_rates)

__all__ = [
    'CHAOS_BANDS', 'ChaosDnsClient', 'ConnectionResetError2',
    'DnsOutcome', 'Fabric', 'LinkModel', 'LoopStarvedError',
    'ManualConnection', 'Scenario', 'ScriptedDnsClient',
    'SimConnection', 'SimWire', 'SimZone', 'VIRTUAL_EPOCH',
    'VirtualClock', 'VirtualLoop', 'encode_response', 'herd',
    'jain_index', 'parse_query', 'quantile', 'run',
    'success_rates',
]
