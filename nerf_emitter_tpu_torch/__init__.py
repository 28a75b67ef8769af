"""PyTorch/CUDA port of nerf_emitter_tpu.

The JAX package `nerf_emitter_tpu` is the reference this package is held
against. This package imports torch and numpy only; the CUDA kernels under
`csrc/` are compiled and loaded lazily (`kernels.build`), on first launch, so
importing it works on a CPU-only torch.

Module paths mirror the JAX package (cameras/rays.py, ops/samplers.py, ...)
so each port sits where its reference does.
"""
