"""composite_image CLI: blend SDF renders over occlusion/background layers.

Port of nerf_emitter_tpu/scripts/composite_image.py: numpy over the
port's utils/exr; same CLI and outputs.

Re-design of the reference's scripts/composite_image.py, applying the
occlusion compositing equation (data/occlusion.py) offline to directories
of rendered frames.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="composite_image")
    ap.add_argument("--render-dir", type=Path, required=True)
    ap.add_argument("--mask-dir", type=Path, required=True)
    ap.add_argument("--background-dir", type=Path, required=True)
    ap.add_argument("--occlusion-dir", type=Path, default=None)
    ap.add_argument("--occlusion-mask-dir", type=Path, default=None)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--pattern", default="*.exr")
    args = ap.parse_args(argv)

    from ..utils import exr

    args.out.mkdir(parents=True, exist_ok=True)
    renders = sorted(args.render_dir.glob(args.pattern))
    for rp in renders:
        rgb = exr.read_exr(rp)[..., :3]
        mask = exr.read_exr(args.mask_dir / rp.name)[..., :1]
        bg = exr.read_exr(args.background_dir / rp.name)[..., :3]
        out = rgb * mask + bg * (1 - mask)
        if args.occlusion_dir is not None:
            occ = exr.read_exr(args.occlusion_dir / rp.name)[..., :3]
            occ_m = exr.read_exr(args.occlusion_mask_dir / rp.name)[..., :1]
            out = occ * occ_m + out * (1 - occ_m)
        exr.write_exr(args.out / rp.name, out.astype(np.float32))
    print(f"composited {len(renders)} frames -> {args.out}")


if __name__ == "__main__":
    main()
