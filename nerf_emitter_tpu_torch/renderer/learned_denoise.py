"""Learned guided denoiser for final renders, KPCN-lite fitted by
noise2noise (port of nerf_emitter_tpu/renderer/learned_denoise.py).

- **Kernel prediction** (Bako et al. 2017): a small CNN predicts per-pixel
  softmax weights over a (2R+1)^2 window, applied to the HDR radiance. The
  weights are convex, so the output conserves energy and never leaves the
  window's range; the network is `depth` 3x3 convs and a 1x1 head.
- **Noise2noise** (Lehtinen et al. 2018): two independent renders of one
  view at the same spp are each other's targets, so the fit needs no clean
  reference; the renderer makes the pairs (`NerfEmitterPipeline.
  fit_scene_denoiser`).
- Guidance (normal, depth, log-luminance) enters only the kernel
  prediction. Inputs are conditioned in log1p space; the kernel is applied
  to the linear radiance.

Plain PyTorch (the reference is XLA, no Pallas kernel). Every conv runs
under `utils.math.f32_convs`: TF32 convs would round the features. flax's
"SAME" 3x3 conv is a zero-padded `Conv2d(padding=1)`; its kernels are HWIO
where torch's are OIHW (`bridge.load_denoiser_params`). `jnp.percentile`
interpolates linearly, as `_percentile` does (by `kthvalue`, which has no
size limit; `torch.quantile` refuses more than 2^24 elements).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.math import f32_convs


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    radius: int = 2  # kernel window = (2R+1)^2 taps
    hidden: int = 48
    depth: int = 4
    fit_steps: int = 400
    lr: float = 2e-3


N_FEATURES = 8  # log1p rgb (3), log-luminance (1), normal (3), depth (1)


class KernelPredictor(nn.Module):
    """(H, W, F) guidance features -> (H, W, (2R+1)^2) softmax weights."""

    def __init__(self, radius: int = 2, hidden: int = 48, depth: int = 4, device=None):
        super().__init__()
        self.radius = radius
        chans = [N_FEATURES] + [hidden] * depth
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1, device=device) for a, b in zip(chans, chans[1:]))
        self.head = nn.Conv2d(chans[-1], (2 * radius + 1) ** 2, 1, device=device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = feats.permute(2, 0, 1)[None]  # NCHW with N=1
        with f32_convs():
            for conv in self.convs:
                h = F.relu(conv(h))
            logits = self.head(h)[0].permute(1, 2, 0)
        return torch.softmax(logits, dim=-1)


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """jnp.percentile(x, q) over every element (linear interpolation)."""
    flat = x.reshape(-1)
    pos = q / 100.0 * (flat.numel() - 1)
    lo = math.floor(pos)
    v_lo = flat.kthvalue(lo + 1).values
    v_hi = flat.kthvalue(min(lo + 2, flat.numel())).values
    return v_lo + (v_hi - v_lo) * (pos - lo)


def _features(rgb: torch.Tensor, normal: Optional[torch.Tensor], depth: Optional[torch.Tensor]) -> torch.Tensor:
    """Conditioning stack: log1p radiance, log-luminance, the normal, and a
    robustly normalised depth (a missing guide is zeros)."""
    h, w, _ = rgb.shape
    lum = torch.log1p(torch.sum(rgb, -1, keepdim=True) / 3.0)
    feats = [torch.log1p(torch.clamp(rgb, min=0.0)), lum]
    feats.append(normal if normal is not None else rgb.new_zeros((h, w, 3)))
    if depth is not None:
        lo, hi = _percentile(depth, 5.0), _percentile(depth, 95.0)
        feats.append((depth - lo) / torch.clamp(hi - lo, min=1e-6))
    else:
        feats.append(rgb.new_zeros((h, w, 1)))
    return torch.cat(feats, dim=-1)


def _window_stack(img: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W, C) -> (H, W, K, C) neighbourhoods by shifts, edge-clamped."""
    h, w, _ = img.shape
    padded = F.pad(img.permute(2, 0, 1)[None], (radius,) * 4, mode="replicate")[0].permute(1, 2, 0)
    taps = [padded[dy:dy + h, dx:dx + w] for dy in range(2 * radius + 1) for dx in range(2 * radius + 1)]
    return torch.stack(taps, dim=2)


def apply_denoiser(module: KernelPredictor, rgb: torch.Tensor, normal: Optional[torch.Tensor] = None,
                   depth: Optional[torch.Tensor] = None, config: DenoiserConfig = DenoiserConfig()) -> torch.Tensor:
    """Denoise an (H, W, 3) HDR radiance image with a fitted predictor."""
    weights = module(_features(rgb, normal, depth))
    stack = _window_stack(rgb, config.radius)  # (H, W, K, 3)
    return torch.sum(stack * weights[..., None], dim=2)


def init_denoiser(generator: torch.Generator, config: DenoiserConfig = DenoiserConfig(),
                  device=None) -> KernelPredictor:
    """A predictor with flax's initialisation: lecun_normal kernels (a normal
    truncated at 2 sigma, scaled to variance 1 / fan_in) and zero biases,
    drawn from `generator` on its device, then moved to `device` (default:
    the generator's)."""
    module = KernelPredictor(config.radius, config.hidden, config.depth, device=generator.device)
    with torch.no_grad():
        for conv in [*module.convs, module.head]:
            fan_in = conv.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncated normal's std is 0.8796 of its scale
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            conv.bias.zero_()
    return module if device is None else module.to(device)


def _rel_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target) / (torch.abs(target).detach() + 1e-2))


def denoiser_loss(module: KernelPredictor, a, b, normal, depth, config: DenoiserConfig) -> torch.Tensor:
    """The symmetric noise2noise loss |f(a) - b| / (|b| + eps) + |f(b) - a| /
    (|a| + eps), averaged: HDR-robust, and its minimiser is the clean
    radiance."""
    fa = apply_denoiser(module, a, normal, depth, config)
    fb = apply_denoiser(module, b, normal, depth, config)
    return _rel_l1(fa, b) + _rel_l1(fb, a)


def fit_denoiser_from(module: KernelPredictor, pairs: list, config: DenoiserConfig = DenoiserConfig()
                      ) -> tuple[KernelPredictor, float]:
    """config.fit_steps Adam steps (optax.adam's defaults at config.lr) on
    `module` in place, step i on pairs[i % len(pairs)]. Returns (module, the
    last step's loss, taken before its update as the reference's is)."""
    opt = torch.optim.Adam(module.parameters(), lr=config.lr)
    loss = torch.tensor(math.inf)
    with torch.enable_grad():
        for i in range(config.fit_steps):
            a, b, normal, depth = pairs[i % len(pairs)]
            opt.zero_grad(set_to_none=True)
            loss = denoiser_loss(module, a, b, normal, depth, config)
            loss.backward()
            opt.step()
    return module, float(loss)


def fit_denoiser(generator: torch.Generator, pairs: list, config: DenoiserConfig = DenoiserConfig()
                 ) -> tuple[KernelPredictor, float]:
    """Noise2noise fit over [(rgb_a, rgb_b, normal, depth), ...] pairs of
    independent renders, from weights drawn from `generator`. The
    predictor lives on the pairs' device. Returns (predictor, final loss)."""
    module = init_denoiser(generator, config, device=pairs[0][0].device)
    return fit_denoiser_from(module, pairs, config)
