"""Training across devices on torch.distributed (port of
nerf_emitter_tpu/parallel/)."""
