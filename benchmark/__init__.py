"""The benchmark of cueball_tpu_torch, the PyTorch and CUDA fleet
runtime: one command runs one cell once (``python -m benchmark.run``);
``BENCHMARK.json`` at the root of the repository lists the cells."""
