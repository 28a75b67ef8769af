"""Procedural synthetic test scene (analytic, no renderer needed); a copy of
nerf_emitter_tpu/data/synthetic.py that writes the same bytes.

A tiny HDR dataset for smoke tests and CI — the role of the reference's
checked-in `tests/data/lego_test` fixture: a diffuse sphere at the origin
inside a directional-gradient HDR environment, rendered analytically with
ray-sphere intersection. Writes instant-ngp style transforms.json + .npy
HDR images so the full dataparser -> datamanager -> trainer path is
exercised without any binary fixtures in the repo.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

SPHERE_RADIUS = 0.35
SPHERE_ALBEDO = np.array([0.8, 0.4, 0.3])
LIGHT_DIR = np.array([0.5, 0.7, 0.5]) / np.linalg.norm([0.5, 0.7, 0.5])


def env_radiance(dirs: np.ndarray) -> np.ndarray:
    """HDR environment: bright lobe around LIGHT_DIR + ambient gradient."""
    cos = np.clip(dirs @ LIGHT_DIR, 0.0, None)
    lobe = 4.0 * cos**8
    ambient = 0.3 + 0.2 * dirs[..., 1:2].clip(0, None)
    rgb = np.stack(
        [lobe * 1.0 + ambient[..., 0], lobe * 0.9 + ambient[..., 0], lobe * 0.7 + ambient[..., 0]],
        axis=-1,
    )
    return rgb.astype(np.float32)


def render_view(c2w: np.ndarray, w: int, h: int, focal: float) -> np.ndarray:
    """Analytic render: sphere (lambertian under LIGHT_DIR) else environment."""
    yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    dx = (xx - w / 2) / focal
    dy = -(yy - h / 2) / focal
    dirs_cam = np.stack([dx, dy, -np.ones_like(dx)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = c2w[:3, 3]

    b = 2.0 * (dirs @ o)
    c = float(o @ o) - SPHERE_RADIUS**2
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, np.inf)
    hit = hit & (t > 0)

    t_safe = np.where(hit, t, 1.0)
    p = o + dirs * t_safe[..., None]
    n = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-9)
    lambert = np.clip(n @ LIGHT_DIR, 0.0, None)[..., None]
    sphere_rgb = SPHERE_ALBEDO * (lambert * 2.0 + 0.25)

    env_rgb = env_radiance(dirs)
    return np.where(hit[..., None], sphere_rgb, env_rgb).astype(np.float32)


def look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, 1.0, 0.0])):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd  # OpenGL: -z forward
    c2w[:3, 3] = eye
    return c2w


def make_synthetic_dataset(
    out_dir: Path,
    n_views: int = 12,
    width: int = 64,
    height: int = 64,
    radius: float = 2.4,
    seed: int = 0,
) -> Path:
    """Write the dataset; returns the directory."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    focal = 0.5 * width / np.tan(0.25)  # ~28deg half-fov

    frames = []
    for i in range(n_views):
        theta = 2 * np.pi * i / n_views
        phi = 0.3 + 0.5 * rng.random()
        eye = radius * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)]
        )
        c2w = look_at(eye.astype(np.float32), np.zeros(3))
        img = render_view(c2w, width, height, focal)
        name = f"r_{i:03d}.npy"
        np.save(out_dir / name, img)
        frames.append(
            {"file_path": name, "transform_matrix": c2w.tolist(), "rotation": 0}
        )

    meta = {
        "fl_x": focal,
        "fl_y": focal,
        "w": width,
        "h": height,
        "cx": width / 2,
        "cy": height / 2,
        "frames": frames,
    }
    with open(out_dir / "transforms.json", "w") as f:
        json.dump(meta, f)
    return out_dir
