"""Run the port's inference-fleet client over the JAX package's pool
layer: ``cueball_tpu_torch.examples.inference_fleet_client`` with the
HTTP agent, static resolver, pool monitor and host seam of
``cueball_tpu``.

    python examples_torch/inference_fleet_client.py [--requests 20] \\
        [--device cpu] [--twin-device cpu] [IP:PORT ...]

Without addresses it serves two HTTP servers in-process. It imports
only ``cueball_tpu``'s framework-neutral modules (the asyncio pool
stack, the clock, the tracer and the loop-lag sampler), never its JAX
modules, so it runs where JAX is not installed.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from cueball_tpu import (agent, monitor, pool, resolver,  # noqa: E402
                         trace, utils, wiretap)
from cueball_tpu_torch.examples import (  # noqa: E402
    inference_fleet_client as example)

if __name__ == '__main__':
    sys.exit(example.main(example.pool_layer(
        agent, resolver, monitor, utils, pool, trace, wiretap)))
