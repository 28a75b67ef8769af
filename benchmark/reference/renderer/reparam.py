"""Warp-field reparameterisation of ray directions, Vicini et al. 2022
(port of nerf_emitter_tpu/renderer/reparam.py).

A visibility discontinuity (a silhouette, a shadow edge) makes the naive
pathwise gradient of an image miss its boundary term. The change of
variables omega -> T(omega, theta), whose theta-velocity matches the
discontinuity's, recovers it: the pointwise derivative of the warped
integrand L(o, T(omega)) |det J_T(omega)| integrates to the total
derivative.

- K points x_i = o + t_i omega along each ray (t_i from a detached trace;
  the last sits on the hit or blocking surface) each vote a direction-
  space velocity v_i = P_omega(-f(x_i; theta) grad f / |grad f|^2) / t_i;
- the votes are weighted by (|f_i| / s + eps)^-p, plus a constant
  background weight, so rays far from any surface get V ~ 0;
- the warp is zero at the primal: T = normalize(omega + V - detach(V)), and
  the area factor is 1 + (div V - detach(div V)), with the spherical
  divergence from two tangent-direction jvps.

The jvps are forward-mode AD (torch.autograd.forward_ad) through a
function that closes over the SDF; ordinary backward then runs through
their outputs. Both tangents go in one pass, the rays stacked twice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.autograd import forward_ad

from ..utils.math import normalize
from .grid3d import sdf_eval, sdf_gradient
from .sphere_trace import SphereTraceConfig, _ray_box_span, sphere_trace


@dataclasses.dataclass(frozen=True)
class WarpConfig:
    num_samples: int = 12  # K points along each ray
    power: float = 3.0  # weight exponent p
    eps: float = 0.05  # weight regulariser (in units of f / scale)
    # f normalisation, the scale below which weights peak; None: one voxel
    # of the SDF grid (it follows the upsample schedule)
    scale: Optional[float] = None
    # |f| at which the warp has decayed to half strength: the background
    # weight equals the mean sample weight of a ray whose closest approach
    # is bg_dist. The level-set velocity does not decay away from the
    # surface, so this is the only decay; too large and every ray carries
    # a spurious warp whose divergence drowns the silhouette. None: 2 voxels.
    bg_dist: Optional[float] = None
    t_floor: float = 0.05  # least distance for the 1/t direction mapping
    t_min: float = 0.02  # skip the region at the ray origin (secondary rays start on the surface)


def _tangent_basis(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis (Duff et al.) for unit directions (N, 3)."""
    s = torch.where(d[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + d[..., 2])
    b = d[..., 0] * d[..., 1] * a
    e1 = torch.stack([1.0 + s * d[..., 0] ** 2 * a, s * b, -s * d[..., 0]], dim=-1)
    e2 = torch.stack([b, s + d[..., 1] ** 2 * a, -d[..., 1]], dim=-1)
    return e1, e2


def reparam_direction(
    sdf: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    trace_config: SphereTraceConfig = SphereTraceConfig(),
    warp: WarpConfig = WarpConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp (N, 3) unit directions -> (d_warped, jacobian). The primal of
    d_warped is normalize(directions) and the primal jacobian is exactly 1;
    their derivatives carry the boundary terms. Multiply each ray's
    radiance by jacobian[:, None] and shade along d_warped."""
    o_det, d_det, sdf_det = origins.detach(), directions.detach(), sdf.detach()
    t_hit_det, hit = sphere_trace(sdf_det, o_det, d_det, trace_config)
    t_enter0, t_exit0 = _ray_box_span(o_det, d_det, trace_config.bbox_min, trace_config.bbox_max)
    valid = (t_enter0 < torch.clamp(t_exit0, max=trace_config.t_max)).float()  # rays that enter the box
    # the denominator of the direction IFT below, detached; clamped on
    # grazing rays, where the hit sample's angular velocity diverges like
    # 1 / (grad f . d) (the bias stays within ~1 degree of grazing)
    with torch.no_grad():
        g_hit = sdf_gradient(sdf_det, o_det + t_hit_det[:, None] * d_det)
        denom = torch.sum(g_hit * d_det, dim=-1)
        denom = torch.where(denom.abs() < 2e-2, torch.sign(denom) * 2e-2, denom)
        denom = torch.where(denom == 0.0, 2e-2, denom)

    voxel = 1.0 / (sdf.shape[0] - 1)
    scale = voxel if warp.scale is None else warp.scale
    bg_dist = 2.0 * voxel if warp.bg_dist is None else warp.bg_dist
    w_bg = (bg_dist / scale + warp.eps) ** (-warp.power)
    fracs = torch.linspace(0.0, 1.0, warp.num_samples, device=origins.device)

    def v_of(o, d_var, t_hit0, den, hit_, valid_):
        # The sample grid moves with omega (not with theta): the dominant
        # weight sits on the hit sample, and a frozen grid would let it
        # slide off the surface under the divergence jvp. Box spans are
        # analytic in d; the hit distance takes its direction derivative
        # from the implicit function theorem on the detached SDF.
        t_enter, t_exit = _ray_box_span(o, d_var, trace_config.bbox_min, trace_config.bbox_max)
        t_exit = torch.clamp(t_exit, max=trace_config.t_max)
        f_h = sdf_eval(sdf_det, o + t_hit0[:, None] * d_var)
        t_hit = t_hit0 - (f_h - f_h.detach()) / den
        t_end = torch.where(hit_, t_hit, t_exit)
        t_start = torch.clamp(t_enter, min=warp.t_min)
        t_end = torch.maximum(t_end, t_start + 1e-4)
        t = t_start[:, None] + (t_end - t_start)[:, None] * fracs[None, :]
        x = o[:, None, :] + t[..., None] * d_var[:, None, :]  # (N, K, 3)
        f_att = sdf_eval(sdf, x)  # attached to theta and x
        f_det = sdf_eval(sdf_det, x)  # attached to x only (the weights)
        g = sdf_gradient(sdf_det, x)  # the level set's normal direction
        g2 = torch.clamp(torch.sum(g * g, dim=-1, keepdim=True), min=1e-6)
        v = -f_att[..., None] * g / g2  # spatial level-set velocity
        # to direction space: project out the radial part, scale by 1/t
        radial = torch.sum(v * d_var[:, None, :], dim=-1, keepdim=True)
        v = (v - radial * d_var[:, None, :]) / torch.clamp(t[..., None], min=warp.t_floor)
        w = (torch.abs(f_det) / scale + warp.eps) ** (-warp.power)
        # the mean (not the sum), so the background cutoff is K-independent
        wsum = torch.mean(w, dim=1) + w_bg
        return torch.mean(w[..., None] * v, dim=1) / wsum[:, None] * valid_[:, None]

    n = directions.shape[0]
    e1, e2 = _tangent_basis(d_det)
    two = lambda t: torch.cat([t, t])  # noqa: E731
    with forward_ad.dual_level():
        d_dual = forward_ad.make_dual(two(directions), torch.cat([e1, e2]))
        out = v_of(two(o_det), d_dual, two(t_hit_det), two(denom), two(hit), two(valid))
        v_both, dv = forward_ad.unpack_dual(out)
    v = v_both[:n]
    div = torch.sum(e1 * dv[:n], dim=-1) + torch.sum(e2 * dv[n:], dim=-1)
    d_w = normalize(directions + (v - v.detach()))
    jac = 1.0 + (div - div.detach())
    return d_w, jac
