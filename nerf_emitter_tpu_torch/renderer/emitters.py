"""Emitters (port of nerf_emitter_tpu/renderer/emitters.py): the vMF
mixture, the path-guiding proposal that importance-samples directions
toward the NeRF's light clusters. The equirect envmap emitter is a later
slice (ROADMAP.md, Queue 1 item 4).

Directions are in the world frame.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..utils.math import normalize


def _orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis (Duff et al.) for (..., 3) normals."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(n: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Local (..., 3) coordinates in the frame around n -> world."""
    t, b = _orthonormal_basis(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


@dataclasses.dataclass
class VMFMixture:
    """K lobes. Directions are sampled toward `positions` as seen from a
    shading point; std sets each lobe's concentration (kappa = 1/std^2)."""

    positions: torch.Tensor  # (K, 3) cluster centres
    weights: torch.Tensor  # (K,) mixture weights, unnormalised
    stds: torch.Tensor  # (K,) angular std in radians

    def _lobe_dirs(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3) shading points -> (N, K, 3) unit directions to each lobe."""
        return normalize(self.positions[None, :, :] - x[:, None, :])

    def _kappas(self) -> torch.Tensor:
        return 1.0 / torch.clamp(self.stds**2, min=1e-6)

    def _mix(self) -> torch.Tensor:
        return self.weights / torch.clamp(torch.sum(self.weights), min=1e-12)

    def pdf(self, x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        """Mixture pdf of (N, 3) directions at (N, 3) points. Each lobe is
        kappa / (4 pi sinh kappa) exp(kappa cos), computed stably."""
        mu = self._lobe_dirs(x)
        kappa = self._kappas()[None, :]
        cos = torch.sum(mu * d[:, None, :], dim=-1)
        log_c = torch.log(kappa) - math.log(2.0 * math.pi) - torch.log1p(-torch.exp(-2.0 * kappa) + 1e-12)
        lobe_pdf = torch.exp(log_c + kappa * (cos - 1.0))
        return torch.sum(self._mix()[None, :] * lobe_pdf, dim=-1)

    def sample(
        self,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        *,
        uniforms: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One direction per point (N, 3) -> (directions (N, 3), pdf (N,)).

        The draws are three uniforms per point, (u_lobe, u_cos, u_phi):
        from `generator`, or given as `uniforms`. u_lobe picks the lobe by
        the mixture's CDF, u_cos the cosine to its axis, u_phi the angle
        about it."""
        n = x.shape[0]
        if uniforms is None:
            uniforms = tuple(torch.rand(n, generator=generator, device=x.device) for _ in range(3))
        u_lobe, u, u_phi = uniforms
        cdf = torch.cumsum(self._mix(), dim=0)
        comp = torch.searchsorted(cdf, u_lobe.contiguous(), right=True).clamp(max=cdf.shape[0] - 1)
        mu = self._lobe_dirs(x)[torch.arange(n, device=x.device), comp]
        kappa = self._kappas()[comp]
        # the cosine: W = 1 + log(u + (1 - u) e^{-2 kappa}) / kappa
        cos_t = 1.0 + torch.log(u + (1.0 - u) * torch.exp(-2.0 * kappa) + 1e-38) / kappa
        cos_t = cos_t.clamp(-1.0, 1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, min=0.0))
        phi = 2.0 * math.pi * u_phi
        local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
        d = to_world(mu, local)
        return d, torch.clamp(self.pdf(x, d), min=1e-9)
