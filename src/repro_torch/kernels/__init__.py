"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the oracles they are held against (``ref``).  Public entry points are
in ``ops``; ``build`` compiles the CUDA sources under ``csrc/``."""
