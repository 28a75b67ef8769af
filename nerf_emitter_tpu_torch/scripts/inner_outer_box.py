"""Outer-box AABB in inner-box coordinates (scene-box calibration).

A numpy copy of nerf_emitter_tpu/scripts/inner_outer_box.py (the port imports nothing
of the JAX package); same CLI and outputs.

Re-design of the reference's `scripts/inner_outer_box.py` (:1-66, a
Blender bpy script reading InnerBox/OuterBox objects from a .blend): the
object region (inner box) and the NeRF environment extent (outer box) are
authored as two transformed unit cubes; training needs the outer box
expressed in the inner box's normalized frame. Inputs here are the two
4x4 world transforms as JSON (no Blender dependency); outputs match the
reference's files: `outer_box_aabb.txt` (2x3) and
`inv_inner_box_transform.txt` (4x4).

  python -m nerf_emitter_tpu_torch.scripts.inner_outer_box \
      --inner inner.json --outer outer.json --output-dir calib/
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

CUBE = np.array(
    [
        [-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
        [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1],
    ],
    np.float64,
)


def outer_in_inner(inner: np.ndarray, outer: np.ndarray):
    inv_inner = np.linalg.inv(inner)
    homo = np.concatenate([CUBE, np.ones((8, 1))], 1)
    verts = (inv_inner @ outer @ homo.T).T[:, :3]
    aabb = np.stack([verts.min(0), verts.max(0)])
    return aabb, inv_inner


def main(argv=None):
    ap = argparse.ArgumentParser(prog="inner_outer_box")
    ap.add_argument("--inner", type=Path, required=True, help="4x4 JSON")
    ap.add_argument("--outer", type=Path, required=True, help="4x4 JSON")
    ap.add_argument("--output-dir", type=Path, default=Path("."))
    args = ap.parse_args(argv)

    inner = np.asarray(json.loads(args.inner.read_text()), np.float64)
    outer = np.asarray(json.loads(args.outer.read_text()), np.float64)
    aabb, inv_inner = outer_in_inner(inner, outer)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    np.savetxt(args.output_dir / "outer_box_aabb.txt", aabb)
    np.savetxt(args.output_dir / "inv_inner_box_transform.txt", inv_inner)
    print(f"outer box in inner frame:\n{aabb}")


if __name__ == "__main__":
    main()
