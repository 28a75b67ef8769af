"""Ray structures: RayBundle, Frustums, RaySamples (port of
nerf_emitter_tpu/cameras/rays.py) as dataclasses of tensors.

Per-sample scalars are (n_rays, n_samples); vector quantities carry a
trailing 3, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Frustums:
    """origins/directions (n_rays, n_samples, 3) (broadcast views);
    starts/ends (n_rays, n_samples) distances along the ray;
    pixel_area (n_rays, n_samples)."""

    origins: torch.Tensor
    directions: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    pixel_area: torch.Tensor

    def get_positions(self) -> torch.Tensor:
        """Midpoint world positions: (..., 3)."""
        mid = (self.starts + self.ends) / 2.0
        return self.origins + self.directions * mid[..., None]


@dataclasses.dataclass
class RaySamples:
    """Samples along rays. Per-sample scalars are (n_rays, n_samples)."""

    frustums: Frustums
    deltas: torch.Tensor
    spacing_starts: torch.Tensor  # warped spacing in [0, 1]
    spacing_ends: torch.Tensor
    camera_indices: Optional[torch.Tensor] = None  # (n_rays, 1) int

    def get_weights(self, densities: torch.Tensor) -> torch.Tensor:
        """w_i = T_i (1 - exp(-sigma_i delta_i)),
        T_i = exp(-sum_{j<i} sigma_j delta_j); densities (n_rays, n_samples)."""
        delta_density = self.deltas * densities
        alphas = 1.0 - torch.exp(-delta_density)
        trans = torch.exp(-torch.cumsum(delta_density[..., :-1], dim=-1))
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans], dim=-1)
        return alphas * trans


@dataclasses.dataclass
class RayBundle:
    """A batch of rays (n, ...): origins/directions (n, 3), pixel_area,
    nears, fars and camera_indices (n, 1)."""

    origins: torch.Tensor
    directions: torch.Tensor
    pixel_area: torch.Tensor
    nears: torch.Tensor
    fars: torch.Tensor
    camera_indices: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "RayBundle":
        return dataclasses.replace(self, **kw)

    def get_ray_samples(
        self,
        bin_starts: torch.Tensor,
        bin_ends: torch.Tensor,
        spacing_starts: torch.Tensor,
        spacing_ends: torch.Tensor,
    ) -> RaySamples:
        """Build RaySamples from per-ray euclidean bins (n_rays, n_samples)."""
        n_samples = bin_starts.shape[-1]

        def broadcast(x):
            return x[..., None, :].expand(*x.shape[:-1], n_samples, x.shape[-1])

        frustums = Frustums(
            origins=broadcast(self.origins),
            directions=broadcast(self.directions),
            starts=bin_starts,
            ends=bin_ends,
            pixel_area=self.pixel_area.expand(bin_starts.shape),
        )
        return RaySamples(
            frustums=frustums,
            deltas=bin_ends - bin_starts,
            spacing_starts=spacing_starts,
            spacing_ends=spacing_ends,
            camera_indices=self.camera_indices,
        )
