"""PyTorch + CUDA port of the RNS datapath (``repro``), served on an H100."""
