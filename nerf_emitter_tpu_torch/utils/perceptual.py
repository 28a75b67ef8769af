"""Perceptual image distance, the reference's LPIPS slot (port of
nerf_emitter_tpu/utils/perceptual.py).

The default is a fixed-seed random-feature pyramid distance, reported as
`lpips_rf` so that it is never confused with VGG-LPIPS. Its kernels are
the JAX package's: `jax.random.normal` draws from `PRNGKey(1772)`,
reproduced here bit for bit by threefry-2x32 in numpy uint32 arithmetic,
as JAX runs it with `jax_threefry_partitionable` on (its default) and
`split` and `normal` on top. Other random kernels would make another
metric.

With NERF_EMITTER_LPIPS_WEIGHTS naming an .npz, the metric is `lpips`, in
one of two layouts:
- VGG16-LPIPS (the torchmetrics/Zhang topology): `vgg_conv0..vgg_conv12`
  (HWIO) + `vgg_bias0..vgg_bias12` + `lin0..lin4` ((C,) non-negative 1x1
  weights), taps after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, 2x2
  maxpools between blocks and the official input shift and scale;
- the legacy pyramid: `conv0..convN` + `lin0..linN` running this module's
  4-stage pyramid with calibrated kernels.

Every conv runs in f32 with TF32 off (`utils.math.f32_convs`).
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from .math import f32_convs

# (out_channels, kernel, stride) per stage: a VGG-ish shrinking pyramid
_STAGES = ((32, 5, 1), (64, 5, 2), (128, 3, 2), (192, 3, 2))
_SEED = 1772

# ---------------------------------------------------------------------------
# JAX's threefry2x32 PRNG in numpy
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) of the counters
    (x0, x1) under key (2,) uint32, as jax.random's threefry2x32_p."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3]) + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for a seed in int32 range: (0, seed)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit flat iota 0..n-1 as (high, low) uint32 words."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split (partitionable threefry): key i = threefry(key, i)."""
    hi, lo = _counters(num)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32-bit jax.random.bits: the two words of threefry(key, flat index)
    xor-ed together."""
    hi, lo = _counters(math.prod(shape))
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


# XLA's f32 erfinv (Giles 2010): a degree-8 polynomial in w = -log1p(-x^2)
# (less 2.5) below w = 5, in sqrt(w) - 3 above, times x
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -np.log1p(-x * x).astype(f32)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt, f32(a), f32(b)) + p * w).astype(f32)
    return (p * x).astype(f32)


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """jax.random.normal in float32: sqrt(2) erfinv(u), u uniform on the
    open (-1, 1) from the bits' 23 mantissa bits. Within 2 ulp of JAX's
    draws (XLA's log1p and fused multiply-adds round otherwise now and
    then)."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.float32(1.0).view(np.uint32)).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    hi = np.float32(1.0)
    u = np.maximum(lo, floats * (hi - lo) + lo)
    return np.float32(np.sqrt(2)) * _erfinv_f32(u)


# ---------------------------------------------------------------------------
# the metric
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _random_kernels() -> tuple[np.ndarray, ...]:
    """The pyramid's HWIO kernels, each filter scaled to unit norm."""
    key = prng_key(_SEED)
    kernels = []
    c_in = 3
    for c_out, k, _ in _STAGES:
        key, k1 = split(key)
        w = normal(k1, (k, k, c_in, c_out))
        w = w / np.sqrt(np.sum(w**2, axis=(0, 1, 2), keepdims=True, dtype=np.float32) + np.float32(1e-8))
        kernels.append(w.astype(np.float32))
        c_in = c_out
    return tuple(kernels)


# VGG16 conv plan: the 13 convs' out channels; LPIPS taps the relu after
# the last conv of each block (indices 1, 3, 6, 9, 12)
_VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_VGG_POOL_BEFORE = (2, 4, 7, 10)  # a 2x2 maxpool precedes these convs
_VGG_TAPS = (1, 3, 6, 9, 12)
# official LPIPS input scaling (ScalingLayer, Zhang et al. 2018 reference code)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


@functools.lru_cache(maxsize=2)
def _load_weights(path: str) -> dict[str, np.ndarray]:
    """The .npz's arrays, read once per path; the VGG layout's conv shapes
    checked."""
    with np.load(path) as data:
        weights = {k: data[k] for k in data.files}
    if "vgg_conv0" in weights:
        for i, c in enumerate(_VGG_CHANNELS):
            want = (3, 3, 3 if i == 0 else _VGG_CHANNELS[i - 1], c)
            if weights[f"vgg_conv{i}"].shape != want:
                raise ValueError(f"vgg_conv{i} has shape {weights[f'vgg_conv{i}'].shape}, not {want}")
    return weights


def _weights_file() -> dict[str, np.ndarray] | None:
    path = os.environ.get("NERF_EMITTER_LPIPS_WEIGHTS")
    return _load_weights(path) if path and os.path.exists(path) else None


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor, stride: int) -> torch.Tensor:
    """XLA's NHWC 'SAME' conv on an NCHW tensor: the padding total
    max((ceil(n / s) - 1) s + k - n, 0) per axis, its smaller half first."""
    pads = []
    for n, k in ((x.shape[3], w_hwio.shape[1]), (x.shape[2], w_hwio.shape[0])):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w_hwio.permute(3, 2, 0, 1), stride=stride)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x**2, dim=1, keepdim=True) + 1e-10)


def _vgg_features(img: torch.Tensor, convs, biases) -> list[torch.Tensor]:
    """img (H, W, 3) in [0, 1] -> the 5 unit-normalised LPIPS taps (NCHW)."""
    x = img.permute(2, 0, 1)[None] * 2.0 - 1.0
    shift = torch.tensor(_LPIPS_SHIFT, device=img.device)[None, :, None, None]
    scale = torch.tensor(_LPIPS_SCALE, device=img.device)[None, :, None, None]
    x = (x - shift) / scale
    feats = []
    for i, (w, b) in enumerate(zip(convs, biases)):
        if i in _VGG_POOL_BEFORE:
            x = F.max_pool2d(x, 2, 2)
        x = torch.relu(_conv_same(x, w, 1) + b[None, :, None, None])
        if i in _VGG_TAPS:
            feats.append(_unit(x))
    return feats


def _features(img: torch.Tensor, kernels) -> list[torch.Tensor]:
    """img (H, W, 3) in [0, 1] -> per-stage unit-normalised features (NCHW)."""
    x = (img - 0.5).permute(2, 0, 1)[None] * 2.0
    feats = []
    for w, (_, _, stride) in zip(kernels, _STAGES):
        x = torch.relu(_conv_same(x, w, stride))
        feats.append(_unit(x))
    return feats


def lpips(pred: torch.Tensor, gt: torch.Tensor) -> tuple[torch.Tensor, str]:
    """Perceptual distance between (H, W, 3) images in [0, 1]. Returns
    (value, metric name): 'lpips' with calibrated weights, 'lpips_rf' with
    the random-feature pyramid."""
    pred, gt = pred.float(), gt.float()
    dev = pred.device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    data = _weights_file()
    with f32_convs():
        if data is not None and "vgg_conv0" in data:
            convs = [t(data[f"vgg_conv{i}"]) for i in range(13)]
            biases = [t(data[f"vgg_bias{i}"]) for i in range(13)]
            total = 0.0
            for i, (a, b) in enumerate(zip(_vgg_features(pred, convs, biases), _vgg_features(gt, convs, biases))):
                lin = torch.clamp(t(data[f"lin{i}"]), min=0.0)[None, :, None, None]
                total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1))
            return total, "lpips"
        if data is not None:
            kernels = [t(data[f"conv{i}"]) for i in range(len(_STAGES))]
            lins = [t(data[f"lin{i}"]) for i in range(len(_STAGES))]
        else:
            kernels, lins = [t(w) for w in _random_kernels()], None
        f_p, f_g = _features(pred, kernels), _features(gt, kernels)
    total = 0.0
    for i, (a, b) in enumerate(zip(f_p, f_g)):
        d = (a - b) ** 2  # (1, c, h, w)
        if lins is not None:
            total = total + torch.mean(torch.sum(d * torch.clamp(lins[i], min=0.0)[None, :, None, None], dim=1))
        else:
            total = total + torch.mean(torch.sum(d, dim=1)) / len(f_p)
    return total, ("lpips" if lins is not None else "lpips_rf")
