"""The port's profiling entry points (ports of scripts/profile_*.py), each
runnable as `python -m nerf_emitter_tpu_torch.scripts.<name>` on a CUDA
device."""
