"""PyTorch + CUDA port of the DistServe serving stack in `src/repro/`.

The layout mirrors the JAX package module for module. Pure-Python modules
are copied (each names its source in its first line); the model, the
engine and the attention kernels are ported, with hand-written CUDA C++
kernels for Hopper under `csrc/`. The package imports neither `jax` nor
anything of `repro`.
"""
