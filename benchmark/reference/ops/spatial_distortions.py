"""Scene contractions (port of nerf_emitter_tpu/ops/spatial_distortions.py)."""

from __future__ import annotations

from typing import Optional

import torch


def scene_contraction(positions: torch.Tensor, order: Optional[float] = None) -> torch.Tensor:
    """Contract R^3 to the radius-2 ball: x if |x|<=1 else (2 - 1/|x|) x/|x|.
    order=None -> L2 norm; order=inf -> L-inf norm (nerfacto default)."""
    if order is None:
        mag = torch.linalg.norm(positions, dim=-1, keepdim=True)
    else:
        mag = positions.abs().amax(dim=-1, keepdim=True)
    mag = mag.clamp(min=1e-10)
    return torch.where(mag <= 1.0, positions, (2.0 - 1.0 / mag) * positions / mag)


def scene_contraction_inf(positions: torch.Tensor) -> torch.Tensor:
    return scene_contraction(positions, order=float("inf"))


def fake_contraction(positions: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Affine map aabb -> [-2, 2]^3 (reference FakeContraction)."""
    unit = (positions - aabb[0]) / (aabb[1] - aabb[0])
    return unit * 4.0 - 2.0


def contracted_to_unit(positions: torch.Tensor) -> torch.Tensor:
    """[-2, 2]^3 -> [0, 1]^3."""
    return (positions + 2.0) / 4.0
