"""Run the port's inference-fleet client on the port's own pool layer:
``cueball_tpu_torch.examples.inference_fleet_client`` with the HTTP
agent, static resolver, pool monitor and host seam of
``cueball_tpu_torch``.

    python examples_torch/inference_fleet_client.py [--requests 20] \\
        [--device cpu] [--twin-device cpu] [IP:PORT ...]

Without addresses it serves two HTTP servers in-process. It imports
nothing of ``cueball_tpu`` and nothing of JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from cueball_tpu_torch.examples import (  # noqa: E402
    inference_fleet_client as example)

if __name__ == '__main__':
    sys.exit(example.main())
