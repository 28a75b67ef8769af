"""Emitters (port of nerf_emitter_tpu/renderer/emitters.py): the
equirectangular environment map, with 2D-CDF importance sampling, and the
vMF mixture, the path-guiding proposal that importance-samples directions
toward the NeRF's light clusters. The NeRF itself is an emitter function
of the integrator (pipelines/nerf_emitter.make_nerf_emitter_fn).

Directions are in the world frame. The equirect parameterisation is theta
from the +y pole and phi about y, 0 at -z (cameras.EQUIRECTANGULAR). A
sampler takes its uniforms from a generator or as given tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..utils.math import normalize
from .bsdf import to_world


def dir_to_equirect(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (u, v) in [0, 1]^2 (u ~ phi, v ~ theta)."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.arctan2(d[..., 0], -d[..., 2])
    return torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi], dim=-1)


def equirect_to_dir(uv: torch.Tensor) -> torch.Tensor:
    phi = (uv[..., 0] - 0.5) * 2.0 * math.pi
    theta = uv[..., 1] * math.pi
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)], dim=-1)


@dataclasses.dataclass
class EnvmapEmitter:
    """image (H, W, 3) linear radiance, with its sampling tables: row_cdf
    (H,) over rows (sin-weighted luminance) and cond_cdf (H, W) along each
    row."""

    image: torch.Tensor
    row_cdf: torch.Tensor
    cond_cdf: torch.Tensor

    @staticmethod
    def create(image: torch.Tensor) -> "EnvmapEmitter":
        h = image.shape[0]
        lum = torch.mean(image, dim=-1)
        theta = (torch.arange(h, dtype=torch.float32, device=image.device) + 0.5) / h * math.pi
        weights = lum * torch.sin(theta)[:, None] + 1e-9
        row_w = torch.sum(weights, dim=1)
        row_cdf = torch.cumsum(row_w, dim=0) / torch.sum(row_w)
        cond_cdf = torch.cumsum(weights, dim=1) / torch.sum(weights, dim=1, keepdim=True)
        return EnvmapEmitter(image=image, row_cdf=row_cdf, cond_cdf=cond_cdf)

    def eval(self, d: torch.Tensor) -> torch.Tensor:
        """Radiance along (..., 3) directions, bilinear in the texels."""
        h, w = self.image.shape[:2]
        uv = dir_to_equirect(d)
        x = uv[..., 0] * w - 0.5
        y = uv[..., 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[..., None], (y - y0)[..., None]
        x0i = torch.remainder(x0.long(), w)
        x1i = torch.remainder(x0i + 1, w)
        y0i = torch.clamp(y0.long(), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        img = self.image
        return (img[y0i, x0i] * (1 - fx) * (1 - fy) + img[y0i, x1i] * fx * (1 - fy)
                + img[y1i, x0i] * (1 - fx) * fy + img[y1i, x1i] * fx * fy)

    def pdf(self, d: torch.Tensor) -> torch.Tensor:
        """Solid-angle pdf of `sample` at (..., 3) directions."""
        h, w = self.image.shape[:2]
        uv = dir_to_equirect(d)
        xi = torch.clamp((uv[..., 0] * w).long(), 0, w - 1)
        yi = torch.clamp((uv[..., 1] * h).long(), 0, h - 1)
        row_pdf = torch.diff(self.row_cdf, prepend=self.row_cdf.new_zeros(1))
        cond_pdf = torch.diff(self.cond_cdf, dim=1, prepend=self.cond_cdf.new_zeros(h, 1))
        p_texel = row_pdf[yi] * cond_pdf[yi, xi]
        sin_t = torch.clamp(torch.sin((yi.float() + 0.5) / h * math.pi), min=1e-6)
        jac = (2.0 * math.pi / w) * (math.pi / h) * sin_t  # the texel's solid angle
        return p_texel / jac

    def sample(
        self,
        shape: tuple,
        generator: Optional[torch.Generator] = None,
        *,
        uniforms: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Importance-sample directions -> (directions (*shape, 3), pdf).

        The draws are (u_row (*shape), u_col (*shape), jitter (*shape, 2)),
        from `generator` or given. The row is the first whose CDF entry is
        not below u_row (searchsorted's left side); the column is the count
        of the row's CDF entries below u_col."""
        h, w = self.image.shape[:2]
        if uniforms is None:
            dev = self.image.device
            uniforms = (torch.rand(shape, generator=generator, device=dev),
                        torch.rand(shape, generator=generator, device=dev),
                        torch.rand((*shape, 2), generator=generator, device=dev))
        u_row, u_col, jitter = uniforms
        yi = torch.clamp(torch.searchsorted(self.row_cdf, u_row.contiguous()), 0, h - 1)
        xi = torch.clamp(torch.sum(self.cond_cdf[yi] < u_col[..., None], dim=-1), 0, w - 1)
        uv = torch.stack([(xi + jitter[..., 0]) / w, (yi + jitter[..., 1]) / h], dim=-1)
        d = equirect_to_dir(uv)
        return d, self.pdf(d)


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
