"""PyTorch/CUDA port of streamvln_tpu for NVIDIA Hopper GPUs.

The JAX package `streamvln_tpu` is the reference; this package imports
nothing of it (nor jax) and mirrors its module names. Hand-written CUDA
kernels live in `csrc/` and build at first use (`kernels/build.py`).
"""
