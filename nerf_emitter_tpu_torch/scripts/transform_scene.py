"""Apply an affine transform to a dataset's camera/calibration metadata.

A numpy copy of nerf_emitter_tpu/scripts/transform_scene.py (the port imports nothing
of the JAX package); same CLI and outputs.

Re-design of the reference's `scripts/transform_xml.py` (:17-132), which
bakes an affine transform into a Mitsuba scene XML (`<matrix>`,
`<translate>` nodes, optionally stripping the scale component for
sensors). This framework's scene descriptions are JSON, so the tool
operates on:

- `transforms.json` (instant-ngp / nerfstudio dataparser input): every
  frame's `transform_matrix` is left-multiplied by T; optional
  `applied_transform` is tracked for provenance.
- a rotation-calibration JSON (`rotations` dict of 4x4 lists, the
  nerfstudio dataparser's calibrated turntable transforms,
  nerfstudio_dataparser.py:373-390): each matrix M becomes T M T^-1
  (conjugation — a world-frame change preserves the relative rotations).

Like the reference's `exclude_scale` flag, `--exclude-scale` re-normalizes
the rotation block per-frame so camera poses keep unit scale while
positions still move.

  python -m nerf_emitter_tpu_torch.scripts.transform_scene \
      --input data/lego/transforms.json --output out.json \
      --matrix 1 0 0 0  0 1 0 0  0 0 1 0  [--exclude-scale] \
      [--rotations-json calib.json] [--conjugate-rotations]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _orthonormalize(m4: np.ndarray) -> np.ndarray:
    """Strip scale from the rotation block (polar decomposition via SVD),
    keep translation — the reference's exclude_scale_component
    (transform_xml.py:43-54) without the quaternion round-trip."""
    out = np.eye(4)
    u, _, vt = np.linalg.svd(m4[:3, :3])
    r = u @ vt
    if np.linalg.det(r) < 0:  # keep it a proper rotation
        u[:, -1] *= -1.0
        r = u @ vt
    out[:3, :3] = r
    out[:3, 3] = m4[:3, 3]
    return out


def transform_frames(meta: dict, T: np.ndarray, exclude_scale: bool) -> dict:
    meta = dict(meta)
    frames = []
    for fr in meta.get("frames", []):
        fr = dict(fr)
        m = np.asarray(fr["transform_matrix"], np.float64)
        if m.shape == (3, 4):
            m = np.concatenate([m, [[0, 0, 0, 1]]], 0)
        m2 = T @ m
        if exclude_scale:
            m2 = _orthonormalize(m2)
        fr["transform_matrix"] = m2.tolist()
        frames.append(fr)
    meta["frames"] = frames
    prev = np.asarray(meta.get("applied_transform", np.eye(4)), np.float64)
    if prev.shape == (3, 4):
        prev = np.concatenate([prev, [[0, 0, 0, 1]]], 0)
    meta["applied_transform"] = (T @ prev).tolist()
    return meta


def conjugate_rotations(calib: dict, T: np.ndarray) -> dict:
    T_inv = np.linalg.inv(T)
    out = dict(calib)
    rot = {}
    for k, m in calib.get("rotations", calib).items():
        m = np.asarray(m, np.float64)
        rot[k] = (T @ m @ T_inv).tolist()
    if "rotations" in calib:
        out["rotations"] = rot
        return out
    return rot


def parse_transform(args) -> np.ndarray:
    T = np.eye(4)
    if args.matrix is not None:
        vals = np.asarray(args.matrix, np.float64)
        if vals.size == 16:
            T = vals.reshape(4, 4)
        elif vals.size == 12:
            T = np.concatenate([vals.reshape(3, 4), [[0, 0, 0, 1]]], 0)
        else:
            raise SystemExit("--matrix needs 12 or 16 values")
    if args.scale != 1.0:
        S = np.diag([args.scale] * 3 + [1.0])
        T = S @ T
    if args.translate is not None:
        T2 = np.eye(4)
        T2[:3, 3] = args.translate
        T = T2 @ T
    return T


def main(argv=None):
    ap = argparse.ArgumentParser(prog="transform_scene")
    ap.add_argument("--input", type=Path, required=True,
                    help="transforms.json to transform")
    ap.add_argument("--output", type=Path, required=True)
    ap.add_argument("--matrix", type=float, nargs="*", default=None,
                    help="row-major 3x4 or 4x4 affine")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--translate", type=float, nargs=3, default=None)
    ap.add_argument("--exclude-scale", action="store_true",
                    help="strip scale from each output pose's rotation")
    ap.add_argument("--rotations-json", type=Path, default=None,
                    help="also conjugate a rotation-calibration JSON")
    args = ap.parse_args(argv)

    T = parse_transform(args)
    meta = json.loads(args.input.read_text())
    out = transform_frames(meta, T, args.exclude_scale)
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text(json.dumps(out, indent=2))
    print(f"wrote {args.output} ({len(out.get('frames', []))} frames)")

    if args.rotations_json is not None:
        calib = json.loads(args.rotations_json.read_text())
        conj = conjugate_rotations(calib, T)
        out_p = args.rotations_json.with_suffix(".transformed.json")
        out_p.write_text(json.dumps(conj, indent=2))
        print(f"wrote {out_p}")


if __name__ == "__main__":
    main()
