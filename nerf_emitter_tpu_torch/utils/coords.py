"""World <-> render-space transforms (port of nerf_emitter_tpu/utils/coords.py).

World space is [-s, s]^3 (nerfstudio/OpenGL convention); the SDF renderer's
render space is the unit cube [0, 1]^3.
"""

from __future__ import annotations

import torch


def world_to_unit(points: torch.Tensor, scene_scale: float) -> torch.Tensor:
    """[-s, s]^3 world -> [0, 1]^3 render space (SDF grid domain)."""
    return (points / scene_scale + 1.0) * 0.5


def unit_to_world(points: torch.Tensor, scene_scale: float) -> torch.Tensor:
    """[0, 1]^3 render space -> [-s, s]^3 world."""
    return (points * 2.0 - 1.0) * scene_scale
