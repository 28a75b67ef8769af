"""HDR numeric helpers (port of nerf_emitter_tpu/utils/math.py)."""

from __future__ import annotations

import torch

# Clamp for exp to avoid float32 overflow (the reference's SAFE_EXP_MAX).
SAFE_EXP_MAX = 88.0

# Rec.709 luminance weights.
_LUMA = (0.2126, 0.7152, 0.0722)


def safe_exp(x: torch.Tensor, *, bias: float = 0.0, max_value: float = SAFE_EXP_MAX) -> torch.Tensor:
    """exp(min(x + bias, max_value)) — HDR radiance output activation."""
    return torch.exp(torch.clamp(x + bias, max=max_value))


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance; rgb: (..., 3) -> (...)."""
    luma = torch.tensor(_LUMA, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * luma, dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """L2-normalize the last axis; rsqrt(max(v.v, eps)) keeps the backward
    finite at v = 0."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=eps))
