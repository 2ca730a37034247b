"""Hand-written CUDA kernels of the port and their build.

The sources live in ``cueball_tpu_torch/csrc/``; :mod:`.build` compiles
them with nvcc on first use. Importing this package builds nothing.
"""

from .build import KERNELS, build_all, load

__all__ = ['KERNELS', 'build_all', 'load']
