"""crop_data CLI: crop dataset images around the object region -> mi_data.

Port of nerf_emitter_tpu/scripts/crop_data.py: numpy over the port's
utils/exr and data/dataparsers/instant_ngp.load_image; same CLI and
outputs.

Re-design of the reference's scripts/crop_data.py: real captures feed the
SDF phase with images cropped to the object's projected bounding box (the
`mi_data` split); this tool projects the object AABB into every camera,
crops with padding, rewrites intrinsics, and emits a new transforms.json.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def project_aabb(c2w: np.ndarray, fx, fy, cx, cy, aabb: np.ndarray):
    """Project the 8 AABB corners -> pixel bbox (xmin, ymin, xmax, ymax)."""
    corners = np.array(
        [[aabb[i, 0], aabb[j, 1], aabb[k, 2]] for i in (0, 1) for j in (0, 1) for k in (0, 1)]
    )
    r = c2w[:3, :3]
    t = c2w[:3, 3]
    cam = (corners - t) @ r  # world -> camera (R^T (p - t))
    z = -cam[:, 2]
    z = np.maximum(z, 1e-6)
    u = fx * cam[:, 0] / z + cx
    v = -fy * cam[:, 1] / z + cy
    return float(u.min()), float(v.min()), float(u.max()), float(v.max())


def main(argv=None):
    ap = argparse.ArgumentParser(prog="crop_data")
    ap.add_argument("data", type=Path)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--aabb", type=float, nargs=6,
                    default=[-0.3, -0.3, -0.3, 0.3, 0.3, 0.3],
                    metavar=("XMIN", "YMIN", "ZMIN", "XMAX", "YMAX", "ZMAX"))
    ap.add_argument("--padding", type=float, default=0.1)
    args = ap.parse_args(argv)

    from ..data.dataparsers.instant_ngp import load_image
    from ..utils import exr

    with open(args.data / "transforms.json") as f:
        meta = json.load(f)
    aabb = np.asarray(args.aabb, np.float32).reshape(2, 3)
    args.out.mkdir(parents=True, exist_ok=True)

    new_frames = []
    for fr in meta["frames"]:
        c2w = np.asarray(fr["transform_matrix"], np.float32)
        fx = float(fr.get("fl_x", meta.get("fl_x")))
        fy = float(fr.get("fl_y", meta.get("fl_y")))
        cx = float(fr.get("cx", meta.get("cx")))
        cy = float(fr.get("cy", meta.get("cy")))
        img = load_image(args.data / fr["file_path"])
        h, w = img.shape[:2]
        u0, v0, u1, v1 = project_aabb(c2w, fx, fy, cx, cy, aabb)
        pad = args.padding * max(u1 - u0, v1 - v0)
        x0 = int(np.clip(u0 - pad, 0, w - 2))
        y0 = int(np.clip(v0 - pad, 0, h - 2))
        x1 = int(np.clip(u1 + pad, x0 + 1, w))
        y1 = int(np.clip(v1 + pad, y0 + 1, h))
        crop = img[y0:y1, x0:x1]
        name = Path(fr["file_path"]).stem + ".exr"
        exr.write_exr(args.out / name, crop.astype(np.float32))
        nf = dict(fr)
        nf["file_path"] = name
        nf["fl_x"], nf["fl_y"] = fx, fy
        nf["cx"], nf["cy"] = cx - x0, cy - y0
        nf["w"], nf["h"] = x1 - x0, y1 - y0
        new_frames.append(nf)

    out_meta = {k: v for k, v in meta.items() if k != "frames"}
    out_meta["frames"] = new_frames
    with open(args.out / "transforms.json", "w") as f:
        json.dump(out_meta, f, indent=1)
    print(f"cropped {len(new_frames)} images -> {args.out}")


if __name__ == "__main__":
    main()
