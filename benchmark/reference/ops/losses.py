"""Losses: HDR photometric losses and the nerfacto regularisers (port of
nerf_emitter_tpu/ops/losses.py).

Every `stop_gradient` of the reference is a `.detach()` here: the
denominators of the RawNeRF and relative losses, and the fine level's bins
and weights in the interlevel loss.
"""

from __future__ import annotations

from typing import Sequence

import torch

# ---------------------------------------------------------------------------
# photometric losses (HDR)
# ---------------------------------------------------------------------------


def rawnerf_loss(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """RawNeRF loss: L2 weighted by the gradient of log tonemapping,
    (pred - gt)^2 / (sg(pred) + eps)^2."""
    scale = pred.detach() + eps
    return torch.mean(((pred - gt) / scale) ** 2)


def relative_l1_loss(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt) / (torch.abs(pred.detach()) + eps))


def relative_l2_loss(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2 / (pred.detach() ** 2 + eps))


def relative_max_l1_loss(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """Relative L1 normalised by the per-pixel max over channels (the
    reference's RelativeMaxL1Loss, as the JAX package defines it)."""
    denom = torch.amax(torch.abs(pred.detach()), dim=-1, keepdim=True) + eps
    return torch.mean(torch.abs(pred - gt) / denom)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


RGB_LOSSES = {
    "l1": l1_loss,
    "l2": l2_loss,
    "mse": l2_loss,
    "rawnerf": rawnerf_loss,
    "relative_l1": relative_l1_loss,
    "relative_l2": relative_l2_loss,
    "relative_max_l1": relative_max_l1_loss,
}


# ---------------------------------------------------------------------------
# proposal/interlevel and distortion losses (nerfacto regularisers)
# ---------------------------------------------------------------------------


def _outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """For each target bin [t0_s, t0_e], the y1 mass of the source bins
    overlapping it (mip-NeRF 360's inner/outer measure, upper bound). All
    shapes (..., S). cy1 is nondecreasing, so cy1[idx] is a max over a
    prefix mask: (..., S0, S1) masks, as the reference builds them."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    # cy1_lo = cy1[searchsorted_right(t1_starts, t0_s) - 1]
    mask_lo = t1_starts[..., None, :] <= t0_starts[..., :, None]
    cy1_lo = torch.amax(torch.where(mask_lo, cy1[..., None, : t1_starts.shape[-1]], 0.0), dim=-1)
    # cy1_hi = cy1[count(t1_ends <= t0_e)]
    mask_hi = t1_ends[..., None, :] <= t0_ends[..., :, None]
    cy1_hi = torch.amax(torch.where(mask_hi, cy1[..., None, 1:], 0.0), dim=-1)
    return cy1_hi - cy1_lo


def lossfun_outer(t, w, t_env, w_env, eps: float = 1e-7):
    """Interlevel loss core: penalise proposal (env) histograms that put
    less mass than the fine histogram in overlapping bins. t (..., S+1)
    fine bin edges, w (..., S) fine weights; t_env/w_env the proposal's."""
    w_outer = _outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + eps)


def interlevel_loss(weights_list: Sequence[torch.Tensor],
                    spacing_bins_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """weights_list[i] (n_rays, S_i); spacing_bins_list[i] (n_rays, S_i+1)
    normalised spacing edges. The LAST entry is the fine (nerf) level;
    only the proposals get a gradient."""
    c = spacing_bins_list[-1].detach()
    w = weights_list[-1].detach()
    total = 0.0
    for cp, wp in zip(spacing_bins_list[:-1], weights_list[:-1]):
        total = total + torch.mean(torch.sum(lossfun_outer(c, w, cp, wp), dim=-1))
    return total


def distortion_loss(weights: torch.Tensor, spacing_starts: torch.Tensor,
                    spacing_ends: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF 360 distortion loss over normalised spacing; weights and
    spacing_* (n_rays, S). The pairwise term sum_ij w_i w_j |m_i - m_j|
    by exclusive cumulative sums (the midpoints are sorted)."""
    w = weights
    m = (spacing_starts + spacing_ends) / 2.0
    interval = spacing_ends - spacing_starts
    wm = w * m
    cw = torch.cumsum(w, dim=-1)
    cwm = torch.cumsum(wm, dim=-1)
    cw_ex = torch.cat([torch.zeros_like(cw[..., :1]), cw[..., :-1]], dim=-1)
    cwm_ex = torch.cat([torch.zeros_like(cwm[..., :1]), cwm[..., :-1]], dim=-1)
    pairwise = 2.0 * torch.sum(wm * cw_ex - w * cwm_ex, dim=-1)
    self_term = torch.sum(w**2 * interval, dim=-1) / 3.0
    return torch.mean(pairwise + self_term)


def orientation_loss(weights: torch.Tensor, normals: torch.Tensor, view_dirs: torch.Tensor) -> torch.Tensor:
    """Ref-NeRF orientation loss: penalise normals facing away from the
    camera. weights (n, S); normals (n, S, 3); view_dirs (n, 3)."""
    n_dot_v = torch.sum(normals * view_dirs[..., None, :], dim=-1)
    return torch.mean(weights * torch.clamp(n_dot_v, min=0.0) ** 2)


def pred_normal_loss(weights: torch.Tensor, normals: torch.Tensor, pred_normals: torch.Tensor) -> torch.Tensor:
    return torch.mean(weights * (1.0 - torch.sum(normals * pred_normals, dim=-1)))
