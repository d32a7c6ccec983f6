"""Hand-written CUDA kernels of the port, one package per kernel package
of ``repro.kernels``: ``ops.py`` holds the wrappers, their plain PyTorch
versions and launch counters; ``csrc/`` the CUDA source.  The shared
headers (profile tables, the quantize rule, the MRC) are in ``csrc/``."""
