"""The web viewer (port of nerf_emitter_tpu/viewer/)."""
