"""Nerfstudio-format dataparser (real captures); a copy of
nerf_emitter_tpu/data/dataparsers/nerfstudio.py.

Re-design of nerfstudio/data/dataparsers/nerfstudio_dataparser.py (444 LoC):
- transforms.json with per-frame intrinsics overrides, mask_path,
  `rotation` tags with `filter_rotation` / `shift_rotation` options
  (:82-91) for turntable captures
- calibrated `rotations` dict -> rotation_transform_matrices +
  rotation_aabb metadata (:373-390)
- pose auto-orientation (up-vector alignment) + auto-scaling into the
  scene box, downscale auto-selection (:422-442)
- `valid_mask` per-frame metadata and mock_split_by_valid
- `mi_data` alternate root (cropped images) for the SDF-phase split
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from .instant_ngp import DataparserOutputs, _split_indices


@dataclasses.dataclass
class NerfstudioDataparserConfig:
    data: Path = Path(".")
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None  # None = auto (longest side <=1600)
    scene_scale: float = 1.0
    auto_scale_poses: bool = True
    orientation_method: str = "up"  # 'up' | 'none'
    center_method: str = "poses"  # 'poses' | 'none'
    train_split_fraction: float = 0.9
    eval_mode: str = "fraction"
    eval_interval: int = 8
    filter_rotation: Optional[int] = None  # keep only this rotation tag
    shift_rotation: int = 0  # cyclic shift of rotation ids
    mi_data: Optional[Path] = None
    aabb_scale: float = 1.0


def _auto_orient_and_center(poses: np.ndarray, config) -> np.ndarray:
    """Align mean up-vector with +y and center camera positions (the
    reference's auto_orient_and_center_poses behavior)."""
    out = poses.copy()
    if config.center_method == "poses":
        center = poses[:, :3, 3].mean(0)
        out[:, :3, 3] -= center
    if config.orientation_method == "up":
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        # rotation taking `up` to +y
        v = np.cross(up, [0.0, 1.0, 0.0])
        s = np.linalg.norm(v)
        c = float(up @ [0.0, 1.0, 0.0])
        if s > 1e-8:
            vx = np.array(
                [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float32
            )
            r = np.eye(3, dtype=np.float32) + vx + vx @ vx * ((1 - c) / (s * s))
            out[:, :3, :3] = np.einsum("ij,njk->nik", r, out[:, :3, :3])
            out[:, :3, 3] = np.einsum("ij,nj->ni", r, out[:, :3, 3])
    return out


def parse_nerfstudio(
    config: NerfstudioDataparserConfig, split: str = "train"
) -> DataparserOutputs:
    root = Path(config.data)
    if split == "mi_train" and config.mi_data is not None:
        root = Path(config.mi_data)
    with open(root / "transforms.json") as f:
        meta = json.load(f)

    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    c2ws, fnames, mnames, rotations, valids = [], [], [], [], []
    fxs, fys, cxs, cys = [], [], [], []
    for fr in frames:
        rot = int(fr.get("rotation", 0))
        if config.filter_rotation is not None and rot != config.filter_rotation:
            continue
        fnames.append(root / fr["file_path"])
        mnames.append(root / fr["mask_path"] if "mask_path" in fr else None)
        c2ws.append(np.asarray(fr["transform_matrix"], np.float32))
        rotations.append(rot)
        valids.append(bool(fr.get("valid", True)))
        fxs.append(float(fr.get("fl_x", meta.get("fl_x", 0.0))))
        fys.append(float(fr.get("fl_y", meta.get("fl_y", 0.0))))
        cxs.append(float(fr.get("cx", meta.get("cx", 0.0))))
        cys.append(float(fr.get("cy", meta.get("cy", 0.0))))

    poses = np.stack(c2ws)
    poses = _auto_orient_and_center(poses, config)
    if config.auto_scale_poses:
        scale = 1.0 / max(float(np.abs(poses[:, :3, 3]).max()), 1e-8)
        poses[:, :3, 3] *= scale * config.scale_factor
    else:
        scale = config.scale_factor
        poses[:, :3, 3] *= scale

    w = int(meta.get("w", 0))
    h = int(meta.get("h", 0))
    d = config.downscale_factor
    if d is None:
        d = 1
        longest = max(w, h)
        while longest / d > 1600:  # reference auto rule (:422-442)
            d *= 2
    fx = np.asarray(fxs, np.float32) / d
    fy = np.asarray(fys, np.float32) / d
    cx = np.asarray(cxs, np.float32) / d
    cy = np.asarray(cys, np.float32) / d

    n = len(fnames)
    sel = _split_indices(
        n,
        config.eval_mode if split != "mi_train" else "all",
        config.train_split_fraction,
        config.eval_interval,
        "train" if split in ("train", "mi_train") else split,
    )

    # rotation ids: dense, with optional cyclic shift (reference
    # shift_rotation)
    uniq = sorted(set(rotations))
    rot_table = {r: i for i, r in enumerate(uniq)}
    n_rot = max(len(uniq), 1)
    rot_ids = np.asarray(
        [(rot_table[r] + config.shift_rotation) % n_rot for r in rotations],
        np.int32,
    )

    metadata = {
        "downscale_factor": d,
        "pose_scale": float(scale),
        # raw tag values are angles in degrees (reference rotater.py:48-58);
        # rolled so rotation_angles[id] matches the shift_rotation relabeling
        "rotation_angles": np.roll(
            np.asarray(uniq, np.float32), config.shift_rotation
        ),
    }
    if "rotations" in meta:
        # calibrated per-id transforms (reference rotation_transform_matrices)
        mats = {
            int(k): np.asarray(v, np.float32) for k, v in meta["rotations"].items()
        }
        metadata["rotation_transform_matrices"] = np.stack(
            [mats[r] for r in sorted(mats)]
        )
    if "rotation_aabb" in meta:
        metadata["rotation_aabb"] = np.asarray(meta["rotation_aabb"], np.float32)

    s = config.aabb_scale
    is_hdr = fnames[0].suffix.lower() in {".exr", ".hdr", ".npy"}
    return DataparserOutputs(
        image_filenames=[fnames[i] for i in sel],
        camera_to_worlds=poses[sel][:, :3, :4],
        fx=fx[sel], fy=fy[sel], cx=cx[sel], cy=cy[sel],
        width=w // d, height=h // d,
        scene_aabb=np.array([[-s] * 3, [s] * 3], np.float32),
        is_hdr=is_hdr,
        rotation_ids=rot_ids[sel],
        mask_filenames=[mnames[i] for i in sel],
        metadata={**metadata, "valid": [valids[i] for i in sel]},
    )
