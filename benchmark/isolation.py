"""The modules a run of the benchmark must never have loaded: JAX and
the JAX package of this repository, compared by the whole top-level
name (the part before the first dot), since ``cueball_tpu_torch``
begins with ``cueball_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'cueball_tpu'})


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split('.', 1)[0] in FORBIDDEN)
