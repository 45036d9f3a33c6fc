"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

Imports ``torch`` and never ``jax`` or ``repro``: the JAX package beside it
is the reference the port is tested against. Kernels that the reference
wrote in Pallas are hand-written CUDA C++ under ``csrc/``, wrapped in
``hopper/``; entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
