"""BSDFs (port of nerf_emitter_tpu/renderer/bsdf.py): Lambertian diffuse
and a principled one (diffuse base plus isotropic GGX specular) with
voxel-grid albedo and roughness, as eval, pdf and sample functions over
batched shading frames.

All directions point away from the surface point: `wi` is the negated
viewing direction, `wo` the light direction, `n` the world-space shading
normal. A sampler takes its uniforms as tensors, so that a caller can
replay the same draws (a checkpointed recompute, or another package's).
"""

from __future__ import annotations

import math

import torch

from ..utils.math import normalize

INV_PI = 1.0 / math.pi


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


def cosine_sample_hemisphere(n: torch.Tensor, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine-weighted direction about n from uniforms u (..., 2) ->
    (direction, pdf)."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack(
        [r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))], dim=-1
    )
    pdf = torch.clamp(local[..., 2], min=1e-8) * INV_PI
    return to_world(n, local), pdf


# ---- diffuse


def diffuse_eval(albedo: torch.Tensor, n: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """f_r cos(theta_o), (..., 3); zero below the horizon."""
    cos_o = torch.sum(n * wo, dim=-1, keepdim=True)
    return albedo * INV_PI * torch.clamp(cos_o, min=0.0)


def diffuse_pdf(n: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.sum(n * wo, dim=-1), min=0.0) * INV_PI


# ---- principled: diffuse base + GGX specular


def _ggx_d(n_dot_h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a2 = alpha * alpha
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * denom * denom, min=1e-9)


def _smith_g1(n_dot_v: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    a2 = alpha * alpha
    return 2.0 * n_dot_v / torch.clamp(n_dot_v + torch.sqrt(a2 + (1.0 - a2) * n_dot_v * n_dot_v), min=1e-9)


def _fresnel_schlick(cos_t: torch.Tensor, f0: float = 0.04) -> torch.Tensor:
    return f0 + (1.0 - f0) * (1.0 - torch.clamp(cos_t, 0.0, 1.0)) ** 5


def principled_eval(albedo, roughness, n, wi, wo) -> torch.Tensor:
    """(diffuse + GGX specular) cos_o; albedo (..., 3), roughness (..., 1)."""
    cos_i = torch.clamp(torch.sum(n * wi, dim=-1, keepdim=True), min=1e-6)
    cos_o = torch.sum(n * wo, dim=-1, keepdim=True)
    valid = cos_o > 0.0
    cos_o_c = torch.clamp(cos_o, min=1e-6)
    h = normalize(wi + wo)
    n_dot_h = torch.clamp(torch.sum(n * h, dim=-1, keepdim=True), min=0.0)
    h_dot_o = torch.clamp(torch.sum(h * wo, dim=-1, keepdim=True), min=0.0)
    alpha = torch.clamp(roughness, 0.02, 1.0) ** 2
    d = _ggx_d(n_dot_h, alpha)
    g = _smith_g1(cos_i, alpha) * _smith_g1(cos_o_c, alpha)
    f = _fresnel_schlick(h_dot_o)
    spec = d * g * f / torch.clamp(4.0 * cos_i * cos_o_c, min=1e-9)
    return torch.where(valid, (albedo * INV_PI + spec) * cos_o_c, 0.0)


def principled_pdf(roughness, n, wi, wo) -> torch.Tensor:
    """The pdf of principled_sample's 50/50 cosine and GGX mixture."""
    cos_o = torch.clamp(torch.sum(n * wo, dim=-1), min=0.0)
    h = normalize(wi + wo)
    n_dot_h = torch.clamp(torch.sum(n * h, dim=-1), min=0.0)
    h_dot_o = torch.clamp(torch.sum(h * wo, dim=-1), min=1e-6)
    alpha = torch.clamp(roughness[..., 0], 0.02, 1.0) ** 2
    pdf_spec = _ggx_d(n_dot_h, alpha) * n_dot_h / (4.0 * h_dot_o)
    return 0.5 * (cos_o * INV_PI) + 0.5 * pdf_spec


def principled_sample(roughness, n, wi, u_cos, u_ggx, u_pick) -> tuple[torch.Tensor, torch.Tensor]:
    """wo by a 50/50 mixture of cosine and GGX half-vector sampling ->
    (wo, pdf). Uniforms: u_cos (..., 2) for the cosine branch, u_ggx
    (..., 2) for the half vector, u_pick (...) picks specular below 0.5."""
    d_cos, _ = cosine_sample_hemisphere(n, u_cos)
    alpha = torch.clamp(roughness[..., 0], 0.02, 1.0) ** 2
    phi = 2.0 * math.pi * u_ggx[..., 1]
    cos_t2 = (1.0 - u_ggx[..., 0]) / (u_ggx[..., 0] * (alpha * alpha - 1.0) + 1.0)
    cos_t = torch.sqrt(torch.clamp(cos_t2, 0.0, 1.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t2, 0.0, 1.0))
    h = to_world(n, torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1))
    d_spec = 2.0 * torch.sum(wi * h, dim=-1, keepdim=True) * h - wi
    wo = torch.where((u_pick < 0.5)[..., None], d_spec, d_cos)
    return wo, torch.clamp(principled_pdf(roughness, n, wi, wo), min=1e-8)
