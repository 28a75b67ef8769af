"""Sample-count scheduling and denoising (port of
nerf_emitter_tpu/renderer/spp_schedule.py): `divide_spp` splits a total
spp into batches so render memory stays bounded; `bilateral_denoise` is a
joint bilateral filter guided by normals and depth, and `no_denoise` the
no-op."""

from __future__ import annotations

import math
from typing import Optional

import torch


def divide_spp(total_spp: int, spp_per_batch: int, power_of_two: bool = True) -> list[int]:
    """Split total_spp into batches of at most spp_per_batch; with
    power_of_two, descending powers of two."""
    if total_spp <= 0:
        return []
    if not power_of_two:
        out = [spp_per_batch] * (total_spp // spp_per_batch)
        if total_spp % spp_per_batch:
            out.append(total_spp % spp_per_batch)
        return out
    out, rest = [], total_spp
    while rest > 0:
        p = 1
        while p * 2 <= min(rest, spp_per_batch):
            p *= 2
        out.append(p)
        rest -= p
    return out


def bilateral_denoise(
    rgb: torch.Tensor,
    normal: Optional[torch.Tensor] = None,
    depth: Optional[torch.Tensor] = None,
    radius: int = 2,
    sigma_space: float = 2.0,
    sigma_color: float = 0.3,
    sigma_guide: float = 0.2,
) -> torch.Tensor:
    """Joint bilateral filter of an (H, W, 3) radiance image, optionally
    guided by (H, W, 3) normals and (H, W, 1) depth; the image wraps at
    its edges."""
    acc = torch.zeros_like(rgb)
    wsum = torch.zeros((*rgb.shape[:2], 1), device=rgb.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            shifted = torch.roll(rgb, (dy, dx), dims=(0, 1))
            w_s = math.exp(-(dy * dy + dx * dx) / (2 * sigma_space**2))
            w_c = torch.exp(-torch.sum((shifted - rgb) ** 2, -1, keepdim=True) / (2 * sigma_color**2))
            weight = w_s * w_c
            if normal is not None:
                ns = torch.roll(normal, (dy, dx), dims=(0, 1))
                weight = weight * torch.exp(-torch.sum((ns - normal) ** 2, -1, keepdim=True) / (2 * sigma_guide**2))
            if depth is not None:
                ds = torch.roll(depth, (dy, dx), dims=(0, 1))
                weight = weight * torch.exp(-((ds - depth) ** 2) / (2 * sigma_guide**2))
            acc = acc + shifted * weight
            wsum = wsum + weight
    return acc / torch.clamp(wsum, min=1e-9)


def no_denoise(rgb: torch.Tensor, **_) -> torch.Tensor:
    return rgb
