"""Hand-written CUDA kernels of the port (``csrc/``), their plain
PyTorch versions and the search stages built on them."""
