"""Hand-written CUDA kernels of the port, one package per Pallas kernel
of ``repro.kernels``: ``ops.py`` holds the wrapper, its plain PyTorch
version and its launch counter; ``csrc/`` the CUDA source."""
