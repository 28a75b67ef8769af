"""Scene colliders (port of nerf_emitter_tpu/ops/colliders.py): set
per-ray near/far before sampling."""

from __future__ import annotations

import torch

from ..cameras.rays import RayBundle
from ..data.scene_box import intersect_aabb


def near_far_collider(rays: RayBundle, near: float, far: float) -> RayBundle:
    return rays.replace(nears=torch.full_like(rays.nears, near), fars=torch.full_like(rays.fars, far))


def aabb_intersect_collider(rays: RayBundle, aabb: torch.Tensor, near_plane: float = 0.05) -> RayBundle:
    """Clip rays to the AABB; a ray that misses gets the degenerate span
    [near_plane, near_plane + 1e-6]."""
    t_min, t_max, hit = intersect_aabb(rays.origins, rays.directions, aabb)
    nears = torch.where(hit, t_min.clamp(min=near_plane), near_plane)
    fars = torch.where(hit, torch.maximum(t_max, nears + 1e-6), near_plane + 1e-6)
    return rays.replace(nears=nears, fars=fars)


def aabb_far_intersect_collider(
    rays: RayBundle, aabb: torch.Tensor, near_plane: float = 0.05, far: float = 1e3
) -> RayBundle:
    """Start rays at the box EXIT: emitter-query rays begin where they leave
    the object bbox, so the NeRF never integrates inside it."""
    _, t_max, hit = intersect_aabb(rays.origins, rays.directions, aabb)
    nears = torch.where(hit, t_max.clamp(min=near_plane), near_plane)
    fars = torch.full_like(rays.fars, far)
    return rays.replace(nears=nears, fars=torch.maximum(fars, nears + 1e-6))
