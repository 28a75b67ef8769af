"""SceneBox, CropMode and ray/AABB intersection (port of
nerf_emitter_tpu/data/scene_box.py).

A ray can be clipped to the segment before, inside or behind an
axis-aligned box: that is how the object region is carved out of the NeRF
and how the light probes skip the object (FAR2INF).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

# Finite stand-in for "infinity": finite fars keep the spacing warps free
# of NaNs while lying beyond any scene extent.
INF_FAR = 1e6


class CropMode(enum.Enum):
    NORMAL = 0  # keep the segment inside the box
    NEAR = 1  # keep the segment between the camera and the box entry
    FAR = 2  # keep the segment behind the box exit (up to the given far)
    FAR2INF = 3  # behind the box exit, extended to INF_FAR
    NEAR2INF = 4  # the whole ray to INF_FAR (no box clipping)


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


@dataclasses.dataclass
class SceneBox:
    """An AABB (2, 3) with an optional world -> box transform (4, 4) and a
    crop mode."""

    aabb: torch.Tensor
    from_world: Optional[torch.Tensor] = None
    crop_mode: CropMode = CropMode.NORMAL

    def get_center(self) -> torch.Tensor:
        return (self.aabb[0] + self.aabb[1]) / 2.0

    def get_diagonal_length(self) -> torch.Tensor:
        return torch.linalg.norm(self.aabb[1] - self.aabb[0])

    def within(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 3) -> (...,) bool: strictly inside the box."""
        return torch.all((points > self.aabb[0]) & (points < self.aabb[1]), dim=-1)

    def clip_near_far(self, origins, directions, nears, fars) -> tuple[torch.Tensor, torch.Tensor]:
        """Clip (nears, fars) (..., 1) by the crop mode. An empty segment
        comes back with near == far, so compositing renders nothing there."""
        o, d = origins, directions
        if self.from_world is not None:
            o = o @ self.from_world[:3, :3].T + self.from_world[:3, 3]
            d = d @ self.from_world[:3, :3].T
        t_min, t_max, hit = intersect_aabb(o, d, self.aabb)
        mode = self.crop_mode
        if mode == CropMode.NORMAL:
            new_near = torch.where(hit, torch.maximum(nears, t_min), nears)
            new_far = torch.where(hit, torch.minimum(fars, t_max), nears)
        elif mode == CropMode.NEAR:
            new_near = nears
            new_far = torch.where(hit, torch.minimum(fars, t_min), fars)
        elif mode == CropMode.FAR:
            new_near = torch.where(hit, torch.maximum(nears, t_max), nears)
            new_far = fars
        elif mode == CropMode.FAR2INF:
            new_near = torch.where(hit, torch.maximum(nears, t_max), nears)
            new_far = torch.full_like(fars, INF_FAR)
        elif mode == CropMode.NEAR2INF:
            new_near = nears
            new_far = torch.full_like(fars, INF_FAR)
        else:
            raise ValueError(f"unknown crop mode {mode}")
        return new_near, torch.maximum(new_far, new_near)
