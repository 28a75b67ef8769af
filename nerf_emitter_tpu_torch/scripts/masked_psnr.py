"""Masked-PSNR CLI: PSNR over a mask between two image directories (port of
nerf_emitter_tpu/scripts/masked_psnr.py).

    python -m nerf_emitter_tpu_torch.scripts.masked_psnr pred_dir gt_dir [--mask-dir DIR] \
        [--pattern '*.exr'] [--device cuda]

Pairs of rendered and ground-truth images (EXR, .npy, or the 8-bit PNGs
that utils/video.write_png writes), optional mask images (else a 4-channel
prediction's alpha); prints the mean PSNR of the sRGB-tonemapped images
and each image's.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.math import linear_to_srgb


def _load(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    if path.suffix.lower() in (".exr", ".hdr"):
        from ..utils import exr

        return exr.read_exr(path)
    if path.suffix.lower() == ".png":
        from ..utils.video import read_png

        return read_png(path).astype(np.float32) / 255.0
    raise ValueError(f"{path}: reads .exr, .npy and .png images")


def masked_psnr(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray | None, device=None) -> float:
    """PSNR of the sRGB-tonemapped RGB channels, over the pixels whose mask
    is above 0.5 (all pixels without a mask), on `device` (None: CUDA)."""
    dev = resolve_device(device)
    p = linear_to_srgb(torch.as_tensor(np.asarray(pred[..., :3], np.float32), device=dev)).double()
    g = linear_to_srgb(torch.as_tensor(np.asarray(gt[..., :3], np.float32), device=dev)).double()
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask[..., :1]) > 0.5, device=dev)
        se = float(((p - g) ** 2 * m).sum()) / max(int(m.sum()) * 3, 1)
    else:
        se = float(((p - g) ** 2).mean())
    return float(10 * np.log10(1.0 / max(se, 1e-12)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="masked_psnr")
    ap.add_argument("pred_dir", type=Path)
    ap.add_argument("gt_dir", type=Path)
    ap.add_argument("--mask-dir", type=Path, default=None)
    ap.add_argument("--pattern", default="*.exr")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    preds = sorted(args.pred_dir.glob(args.pattern))
    gts = sorted(args.gt_dir.glob(args.pattern))
    if not preds or len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions against {len(gts)} ground-truth images")
    masks = sorted(args.mask_dir.glob(args.pattern)) if args.mask_dir else [None] * len(preds)
    vals = []
    for p, g, m in zip(preds, gts, masks):
        pm = _load(p)
        gm = _load(g)
        mm = _load(m) if m is not None else (pm[..., 3:4] if pm.shape[-1] == 4 else None)
        vals.append(masked_psnr(pm, gm, mm, device=dev))
    out = {"psnr": float(np.mean(vals)), "per_image": vals}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
