"""PyTorch and CUDA port of the ICQ system (the JAX package ``repro``
is its reference).  It serves the paper's two-step search from a saved
artifact directory on an NVIDIA H100 through hand-written CUDA kernels
(``kernels/csrc``); each kernel has a plain PyTorch version, which runs
for tensors on the CPU.  See README.md, "PyTorch / H100 port"."""
