"""Ray/AABB intersection (the port's own copy of
nerf_emitter_tpu/data/scene_box.py `intersect_aabb`)."""

from __future__ import annotations

import torch


def intersect_aabb(
    origins: torch.Tensor,
    directions: torch.Tensor,
    aabb: torch.Tensor,
    eps: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab-test ray/AABB intersection.

    origins/directions: (..., 3); aabb: (2, 3) [min; max].
    Returns (t_min, t_max, hit), each (..., 1); t clamped at >= 0.
    """
    tiny = torch.where(directions >= 0, eps, -eps)
    inv_dir = 1.0 / torch.where(directions.abs() < eps, tiny, directions)
    t0 = (aabb[0] - origins) * inv_dir
    t1 = (aabb[1] - origins) * inv_dir
    t_min = torch.minimum(t0, t1).amax(dim=-1, keepdim=True)
    t_max = torch.maximum(t0, t1).amin(dim=-1, keepdim=True)
    hit = (t_min <= t_max) & (t_max > 0.0)
    return t_min.clamp(min=0.0), t_max.clamp(min=0.0), hit
