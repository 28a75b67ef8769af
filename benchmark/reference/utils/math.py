"""HDR, colorimetry and metric helpers (port of
nerf_emitter_tpu/utils/math.py)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# Clamp for exp to avoid float32 overflow (the reference's SAFE_EXP_MAX).
SAFE_EXP_MAX = 88.0

# Rec.709 luminance weights.
_LUMA = (0.2126, 0.7152, 0.0722)


def safe_exp(x: torch.Tensor, *, bias: float = 0.0, max_value: float = SAFE_EXP_MAX) -> torch.Tensor:
    """exp(min(x + bias, max_value)) — HDR radiance output activation."""
    return torch.exp(torch.clamp(x + bias, max=max_value))


def linear_to_srgb(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Linear radiance -> sRGB, with values clamped to [0, 1]."""
    x = torch.clamp(x, 0.0, 1.0)
    srgb = torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=eps), 1.0 / 2.4) - 0.055)
    return torch.clamp(srgb, 0.0, 1.0)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.04045, x / 12.92, torch.pow((x + 0.055) / 1.055, 2.4))


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance; rgb: (..., 3) -> (...)."""
    luma = torch.tensor(_LUMA, dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * luma, dim=-1)


def normalize(v: torch.Tensor, eps: float = 1e-24) -> torch.Tensor:
    """L2-normalize the last axis; rsqrt(max(v.v, eps)) keeps the backward
    finite at v = 0."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    return v * torch.rsqrt(torch.clamp(n2, min=eps))


def expected_sin(mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """E[sin(x)] for x ~ N(mean, var) — integrated positional encodings."""
    return torch.exp(-0.5 * var) * torch.sin(mean)


def masked_reduction(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `value` over elements where mask is true (mask broadcastable)."""
    mask = torch.broadcast_to(mask, value.shape).to(value.dtype)
    return torch.sum(value * mask) / torch.clamp(torch.sum(mask), min=1.0)


def psnr(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def mape(pred: torch.Tensor, gt: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """Mean absolute percentage error for HDR images."""
    return torch.mean(torch.abs(pred - gt) / (torch.abs(gt) + eps))


@contextlib.contextmanager
def f32_convs():
    """Convolutions in true f32 inside the block: cuDNN allows TF32 in
    convs by default, and the metrics' convs must not round their inputs
    (the reference runs them at Precision.HIGHEST)."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


def ssim(pred: torch.Tensor, gt: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Structural similarity over (H, W, C) images, 11x11 gaussian window
    (shrunk to the largest odd tap count that fits images smaller than 11
    pixels: a VALID conv with a window larger than the image has no output).

    The window convs run in f32 with TF32 off: at lower precision the
    variance term filt(x*x) - mu^2 cancels catastrophically on smooth
    regions and gives |SSIM| >> 1. The variances are clamped at 0 besides,
    so that rounding noise cannot flip the denominator's sign."""
    pred = pred.float()
    gt = gt.float()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    taps = min(11, pred.shape[0], pred.shape[1])
    taps = taps if taps % 2 == 1 else taps - 1
    x = torch.arange(taps, dtype=torch.float32, device=pred.device) - (taps - 1) / 2.0
    g = torch.exp(-0.5 * (x / 1.5) ** 2)
    g = g / torch.sum(g)
    n_ch = pred.shape[-1]
    kernel = torch.outer(g, g).expand(n_ch, 1, taps, taps)

    def filt(img):
        # (H, W, C) -> a depthwise VALID conv per channel -> (H', W', C)
        out = F.conv2d(img.permute(2, 0, 1)[None], kernel, groups=n_ch)
        return out[0].permute(1, 2, 0)

    with f32_convs():
        mu_p, mu_g = filt(pred), filt(gt)
        mu_pp, mu_gg, mu_pg = mu_p * mu_p, mu_g * mu_g, mu_p * mu_g
        sigma_pp = torch.clamp(filt(pred * pred) - mu_pp, min=0.0)
        sigma_gg = torch.clamp(filt(gt * gt) - mu_gg, min=0.0)
        sigma_pg = filt(pred * gt) - mu_pg
    num = (2 * mu_pg + c1) * (2 * sigma_pg + c2)
    den = (mu_pp + mu_gg + c1) * (sigma_pp + sigma_gg + c2)
    return torch.mean(num / den)
