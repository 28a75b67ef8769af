"""Volume-rendering compositors (port of nerf_emitter_tpu/ops/rendering.py).

HDR: the composited RGB is not clamped, and the last-sample background
completion uses linear radiance.
"""

from __future__ import annotations

import torch

from ..utils.device import rand


def composite_rgb(
    rgb: torch.Tensor,
    weights: torch.Tensor,
    *,
    background_color: str = "random",
    hdr: bool = False,
    is_training: bool = True,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """rgb (..., S, 3), weights (..., S) -> (..., 3)."""
    comp = torch.sum(weights[..., None] * rgb, dim=-2)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    if background_color == "last_sample":
        bg = rgb[..., -1, :]
    elif background_color == "white":
        bg = torch.ones_like(comp)
    elif background_color == "black":
        bg = torch.zeros_like(comp)
    elif background_color == "random":
        if generator is not None and is_training:
            bg = rand(comp.shape, generator, comp.device)
        else:
            bg = torch.zeros_like(comp)
    else:
        raise ValueError(background_color)
    out = comp + bg * (1.0 - acc)
    if not hdr and not is_training:
        out = out.clamp(0.0, 1.0)
    return out


def composite_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """(..., S) -> (..., 1)."""
    return torch.sum(weights, dim=-1, keepdim=True)


def composite_normals(normals: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(..., S, 3), (..., S) -> (..., 3)."""
    return torch.sum(weights[..., None] * normals, dim=-2)


def composite_generic(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """values (..., S, C), weights (..., S) -> (..., C)."""
    return torch.sum(weights[..., None] * values, dim=-2)


def composite_depth(
    weights: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    *,
    method: str = "median",
    values: torch.Tensor | None = None,
) -> torch.Tensor:
    """weights/starts/ends/values (..., S) -> depth (..., 1).

    'expected': weight-averaged midpoint; 'median': depth where the
    cumulative weight crosses 0.5; 'contrib': depth at the max
    weight*value sample."""
    steps = (starts + ends) / 2.0
    if method == "expected":
        depth = torch.sum(weights * steps, dim=-1, keepdim=True) / (
            torch.sum(weights, dim=-1, keepdim=True) + 1e-10
        )
        return torch.minimum(torch.maximum(depth, steps[..., :1]), steps[..., -1:])
    if method == "median":
        cum = torch.cumsum(weights, dim=-1)
        total = cum[..., -1:]
        idx = torch.sum(cum < 0.5 * torch.clamp(total * 2.0, max=1.0), dim=-1, keepdim=True)
        idx = idx.clamp(0, steps.shape[-1] - 1)
        return torch.gather(steps, -1, idx)
    if method == "contrib":
        if values is None:
            raise ValueError("contrib depth needs per-sample values")
        idx = torch.argmax(weights * values, dim=-1, keepdim=True)
        return torch.gather(steps, -1, idx)
    raise ValueError(method)
