"""instant-ngp / Blender-style transforms.json dataparser (synthetic scenes);
a copy of nerf_emitter_tpu/data/dataparsers/instant_ngp.py.

Re-design of nerfstudio/data/dataparsers/instant_ngp_dataparser.py:45-281:
- transforms.json with `camera_angle_x` or explicit fl_x/fl_y/cx/cy/w/h
- per-frame `rotation` tags -> metadata (turntable multi-light captures)
- `mi_data` alternate directory for the SDF-phase full-image split
- eval_mode: fraction | interval | filename | all
- separate test_data/val_data roots for relighting ground truth
- HDR detection by image suffix (.exr/.hdr/.npy-float)
- world positions scaled by `scene_scale` (default 1/3, reference :153)

Images load host-side with numpy/PIL (plus the pure-python EXR codec in
utils/exr.py); the stacked result is shipped to device once.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataparserOutputs:
    """Host-side parse result (numpy); converted to device arrays by the
    datamanager."""

    image_filenames: list
    camera_to_worlds: np.ndarray  # (n, 3, 4) OpenGL
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int
    scene_aabb: np.ndarray  # (2, 3)
    is_hdr: bool
    rotation_ids: Optional[np.ndarray] = None  # (n,) int
    mask_filenames: Optional[list] = None
    metadata: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class InstantNGPDataparserConfig:
    data: Path = Path(".")
    scene_scale: float = 1.0 / 3.0
    aabb_scale: float = 1.5
    eval_mode: str = "fraction"  # fraction | interval | all | filename
    train_split_fraction: float = 0.9
    eval_interval: int = 8
    mi_data: Optional[Path] = None  # alternate dir for the mi_train split
    test_data: Optional[Path] = None  # relighting GT root
    downscale_factor: int = 1


HDR_SUFFIXES = {".exr", ".hdr", ".npy"}


def _split_indices(n: int, mode: str, fraction: float, interval: int, split: str):
    idx = np.arange(n)
    if mode == "all":
        return idx
    if mode == "fraction":
        n_train = math.ceil(n * fraction)
        step = n / max(n_train, 1)
        train = np.unique((np.arange(n_train) * step).astype(int))
        if split == "train":
            return train
        return np.setdiff1d(idx, train)
    if mode == "interval":
        mask = idx % interval == 0
        return idx[~mask] if split == "train" else idx[mask]
    raise ValueError(mode)


def parse_instant_ngp(
    config: InstantNGPDataparserConfig, split: str = "train"
) -> DataparserOutputs:
    """split: train | val | test | mi_train."""
    root = Path(config.data)
    if split == "mi_train" and config.mi_data is not None:
        root = Path(config.mi_data)
    if split in ("test", "val") and config.test_data is not None:
        root = Path(config.test_data)

    meta_path = root / "transforms.json"
    if not meta_path.exists():
        # Blender-style per-split transforms
        alt = root / f"transforms_{'train' if split == 'mi_train' else split}.json"
        if alt.exists():
            meta_path = alt
        else:
            meta_path = root / "transforms_train.json"
    with open(meta_path) as f:
        meta = json.load(f)

    frames = meta["frames"]
    c2ws, fnames, rotations = [], [], []
    for fr in frames:
        path = root / fr["file_path"]
        if path.suffix == "":
            for suf in (".png", ".exr", ".npy", ".jpg", ".hdr"):
                if path.with_suffix(suf).exists():
                    path = path.with_suffix(suf)
                    break
        fnames.append(path)
        c2ws.append(np.asarray(fr["transform_matrix"], np.float32))
        rotations.append(int(fr.get("rotation", 0)))
    c2w = np.stack(c2ws)  # (n, 4, 4)
    c2w[:, :3, 3] *= config.scene_scale

    # intrinsics
    if "fl_x" in meta:
        fl_x = float(meta["fl_x"])
        fl_y = float(meta.get("fl_y", fl_x))
        w = int(meta["w"])
        h = int(meta["h"])
        cx = float(meta.get("cx", w / 2))
        cy = float(meta.get("cy", h / 2))
    else:
        # probe first image for dims
        w, h = _image_size(fnames[0])
        angle_x = float(meta["camera_angle_x"])
        fl_x = 0.5 * w / math.tan(0.5 * angle_x)
        if "camera_angle_y" in meta:
            fl_y = 0.5 * h / math.tan(0.5 * float(meta["camera_angle_y"]))
        else:
            fl_y = fl_x
        cx, cy = w / 2, h / 2

    d = config.downscale_factor
    if d > 1:
        fl_x, fl_y, cx, cy = fl_x / d, fl_y / d, cx / d, cy / d
        w, h = w // d, h // d

    n = len(frames)
    sel = _split_indices(
        n,
        config.eval_mode if split != "mi_train" else "all",
        config.train_split_fraction,
        config.eval_interval,
        "train" if split in ("train", "mi_train") else split,
    )

    is_hdr = fnames[0].suffix.lower() in HDR_SUFFIXES
    s = config.aabb_scale
    aabb = np.array([[-s, -s, -s], [s, s, s]], np.float32)

    # rotation tags are ANGLES in degrees (reference rotater.py:48-58);
    # densify to ids and keep the unique angles for Rotater.from_angles
    uniq_rot = sorted(set(rotations))
    rot_table = {r: i for i, r in enumerate(uniq_rot)}
    rot_ids = np.asarray([rot_table[r] for r in rotations], np.int32)

    return DataparserOutputs(
        image_filenames=[fnames[i] for i in sel],
        camera_to_worlds=c2w[sel][:, :3, :4],
        fx=np.full(len(sel), fl_x, np.float32),
        fy=np.full(len(sel), fl_y, np.float32),
        cx=np.full(len(sel), cx, np.float32),
        cy=np.full(len(sel), cy, np.float32),
        width=w,
        height=h,
        scene_aabb=aabb,
        is_hdr=is_hdr,
        rotation_ids=rot_ids[sel],
        metadata={
            "downscale_factor": d,
            "envmap": meta.get("envmap"),
            "rotation_angles": np.asarray(uniq_rot, np.float32),
            # dataset-declared object box (world): generators know the
            # object's true extent; overrides the config default downstream
            "object_aabb": (
                np.asarray(meta["object_aabb"], np.float32)
                if "object_aabb" in meta
                else None
            ),
        },
    )


def _image_size(path: Path) -> tuple[int, int]:
    if path.suffix == ".npy":
        arr = np.load(path, mmap_mode="r")
        return arr.shape[1], arr.shape[0]
    if path.suffix.lower() == ".exr":
        from ...utils import exr

        h, w = exr.read_exr_size(path)
        return w, h
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def load_image(path: Path, downscale: int = 1) -> np.ndarray:
    """Load an image as float32 (H, W, C); HDR formats keep linear values,
    LDR formats return [0,1] sRGB-encoded values."""
    path = Path(path)
    if path.suffix == ".npy":
        img = np.load(path).astype(np.float32)
    elif path.suffix.lower() == ".exr":
        from ...utils import exr

        img = exr.read_exr(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            img = np.asarray(im).astype(np.float32) / 255.0
    if downscale > 1:
        img = img[::downscale, ::downscale]
    return img
