"""PyTorch/CUDA port of the JAX package ``repro`` for NVIDIA Hopper.

Imports ``torch``, ``numpy`` and the standard library only — never JAX and
never the JAX package, whose framework-neutral parts it copies.  Module
names mirror the JAX package's.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
