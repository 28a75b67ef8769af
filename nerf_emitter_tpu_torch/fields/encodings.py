"""Position and direction encodings (port of
nerf_emitter_tpu/fields/encodings.py: `nerf_encode`, `sh_encode`).

These are the model path's encodings: direct sin/cos per octave. The
kernels use the double-angle recurrence instead (ops/fused_field.py).
"""

from __future__ import annotations

import math

import torch


def sh_components(x, y, z, degree: int = 4) -> list:
    """Real SH basis components up to `degree` bands (<= 4 -> 16), each
    shaped like x; same coefficients and order as the reference."""
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        comps += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree > 2:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree > 3:
        comps += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    if degree > 4:
        raise NotImplementedError("SH degree > 4")
    return comps


def sh_encode(directions: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Unit directions (..., 3) -> (..., degree**2)."""
    comps = sh_components(directions[..., 0], directions[..., 1], directions[..., 2], degree)
    return torch.stack(comps, dim=-1)


def nerf_encode(
    x: torch.Tensor,
    num_frequencies: int = 10,
    min_freq_exp: float = 0.0,
    max_freq_exp: float = 9.0,
    include_input: bool = True,
) -> torch.Tensor:
    """(..., D) -> (..., D*(2F+1)): [x, sin (d-major, f-minor), cos]."""
    freqs = 2.0 ** torch.linspace(min_freq_exp, max_freq_exp, num_frequencies, device=x.device)
    scaled = (x[..., :, None] * freqs).reshape(*x.shape[:-1], -1)
    parts = [torch.sin(2.0 * math.pi * scaled), torch.cos(2.0 * math.pi * scaled)]
    if include_input:
        parts = [x] + parts
    return torch.cat(parts, dim=-1)
