"""Command-line tools of the port:

    python -m cueball_tpu_torch.tools.chip_bench [--out FILE] [--log FILE]

captures the port bench's record from the CUDA card (see
:mod:`.chip_bench`).
"""
