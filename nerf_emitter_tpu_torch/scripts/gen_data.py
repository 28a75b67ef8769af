"""Synthetic dataset generator: an SDF object rendered inside an HDR
environment with the port's own renderer (port of
nerf_emitter_tpu/scripts/gen_data.py).

    python -m nerf_emitter_tpu_torch.scripts.gen_data --object composite --albedo bands \
        --n-views 60 --width 128 --height 128 --spp 32 --out data/scene [--device cuda]

Writes transforms.json (the poses, the intrinsics, the object's box and
per-frame turntable tags), env.exr (and env_<angle>.exr per light rotation),
the ground truth gt_sdf.npy and gt_albedo.npy, and r_XXXX.exr per view:
RGB with the hit mask as alpha. The poses and turntable tags are the JAX
generator's numpy draws from `--seed`, and the ground-truth volumes are
made on the host, so transforms.json and the volumes do not depend on the
device. The images are direct-illumination renders (renderer/integrator.
render_spp, the soft silhouette: primal-identical to the warp and cheaper)
in calls of at most 8 spp, averaged; their random numbers come from a
`torch.Generator` seeded with `--seed` on the device. With `--resume`,
views whose EXR exists are skipped and the generator still draws their
numbers, so the views that are rendered again come out bit-identical to a
fresh run.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..cameras.cameras import Cameras
from ..data.synthetic import look_at
from ..renderer.emitters import EnvmapEmitter
from ..renderer.grid3d import box_sdf_grid, composite_sdf_grid, sphere_sdf_grid
from ..renderer.integrator import RenderConfig, draw_direct, render_spp
from ..renderer.scene import SdfScene
from ..renderer.sensors import camera_rays_in_render_space
from ..utils import exr
from ..utils.device import resolve_device

SCENE_SCALE = 1.0  # world [-1, 1]; the dataparser scales the cameras later
MAX_SPP_PER_CALL = 8
BAND_COLORS = np.array([[0.70, 0.22, 0.18], [0.18, 0.52, 0.70], [0.72, 0.62, 0.22]], np.float32)


def _procedural_envmap(h=256, w=512) -> np.ndarray:
    """A default HDR environment: sun lobe + sky gradient."""
    ys = (np.arange(h) + 0.5) / h * np.pi
    xs = ((np.arange(w) + 0.5) / w - 0.5) * 2 * np.pi
    theta, phi = np.meshgrid(ys, xs, indexing="ij")
    d = np.stack(
        [np.sin(theta) * np.sin(phi), np.cos(theta), -np.sin(theta) * np.cos(phi)],
        -1,
    )
    sun = np.array([0.4, 0.8, 0.45]) / np.linalg.norm([0.4, 0.8, 0.45])
    cos = np.clip(d @ sun, 0, None)
    lobe = 20.0 * cos**64
    sky = 0.4 + 0.6 * np.clip(d[..., 1], 0, None)
    img = np.stack(
        [lobe + 0.9 * sky, lobe * 0.95 + 0.95 * sky, lobe * 0.85 + 1.1 * sky], -1
    )
    return img.astype(np.float32)


def _yaw(a_deg: float) -> np.ndarray:
    a = np.deg2rad(a_deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def camera_poses(n_views: int, radius: float, path_type: str, rot_angles: list, seed: int):
    """The capture poses (world c2w, 4x4), the render poses (c2w in the
    object's canonical frame) and each view's rotation index. Turntable
    convention (the training side's Rotater): the stored c2w is the world
    (light) frame's pose and the object turns by R(angle) about +y in view
    i, so the render camera is R(-angle) c2w."""
    rng = np.random.default_rng(seed)
    c2ws, c2ws_render, frame_rots = [], [], []
    for i in range(n_views):
        if path_type == "spiral":
            th = 4 * np.pi * i / n_views
            ph = 0.15 + 0.9 * i / n_views
        else:
            th = rng.uniform(0, 2 * np.pi)
            ph = rng.uniform(0.1, 1.2)
        eye = radius * np.array([np.cos(th) * np.cos(ph), np.sin(ph), np.sin(th) * np.cos(ph)])
        c2w = look_at(eye.astype(np.float32), np.zeros(3))
        rot_idx = i % len(rot_angles)
        frame_rots.append(rot_idx)
        c2w_render = c2w.copy()
        c2w_render[:3, :4] = _yaw(-rot_angles[rot_idx]) @ c2w[:3, :4]
        c2ws.append(c2w)
        c2ws_render.append(c2w_render)
    return c2ws, c2ws_render, frame_rots


def gt_volumes(obj: str, albedo_kind: str, tex_res: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """The ground-truth SDF (R, R, R, 1) and albedo (T, T, T, 3), made on the
    host: 'sphere', 'box', 'composite' or a path to an .npy SDF volume;
    albedo 'const' (0.6) or 'bands' (colour bands along y, checker-modulated
    in x and z, so material recovery is a real task)."""
    if obj == "sphere":
        sdf = sphere_sdf_grid(129, radius=0.22).numpy()
    elif obj == "box":
        sdf = box_sdf_grid(129, half_extent=0.18).numpy()
    elif obj == "composite":
        sdf = composite_sdf_grid(129).numpy()
    else:
        sdf = np.load(obj).astype(np.float32)
        if sdf.ndim == 3:
            sdf = sdf[..., None]
    albedo = np.full((tex_res,) * 3 + (3,), 0.6, np.float32)
    if albedo_kind == "bands":
        u = (np.arange(tex_res) + 0.5) / tex_res
        bx, by, bz = np.meshgrid(u, u, u, indexing="ij")
        band = np.minimum((by * 3).astype(np.int64), 2)
        checker = ((bx * 6).astype(np.int64) + (bz * 6).astype(np.int64)) % 2
        albedo = (BAND_COLORS[band] * (0.75 + 0.25 * checker)[..., None]).astype(np.float32)
    return sdf, albedo


def object_box(sdf: np.ndarray, scene_scale: float = SCENE_SCALE) -> list:
    """The object's box in world coordinates: the true extent of the SDF's
    interior plus 20% and a node, so training's carve-out and TSDF box
    always contain the object (a too-small configured box breaks both)."""
    grid = sdf[..., 0]
    res = grid.shape[0]
    neg = np.argwhere(grid < 0)
    if not len(neg):
        return [[-0.3] * 3, [0.3] * 3]
    lo_u = neg.min(axis=0) / (res - 1)
    hi_u = neg.max(axis=0) / (res - 1)
    c_u = (lo_u + hi_u) / 2.0
    half_u = (hi_u - lo_u) / 2.0 * 1.2 + 1.0 / res
    lo_w = ((c_u - half_u) * 2.0 - 1.0) * scene_scale
    hi_w = ((c_u + half_u) * 2.0 - 1.0) * scene_scale
    return [lo_w.tolist(), hi_w.tolist()]


def spp_calls(spp: int) -> tuple[int, int]:
    """(spp per call, calls): at most MAX_SPP_PER_CALL samples a call, as
    many calls as fit in spp."""
    per = min(spp, MAX_SPP_PER_CALL)
    return per, max(1, spp // per)


@torch.no_grad()
def render_view(scene: SdfScene, cams: Cameras, i: int, spp: int, generator: Optional[torch.Generator] = None,
                draws: Optional[list] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """View i at pixel centres: the mean of spp_calls(spp) render_spp calls
    -> (rgb (H, W, 3), hit mask (H, W, 1) of the last call). Each call's
    draws come from `generator`, or from `draws` (one DirectDraws per call,
    spp-leading)."""
    h, w = cams.height, cams.width
    per, calls = spp_calls(spp)
    o, d = camera_rays_in_render_space(cams, i, h, w, SCENE_SCALE)
    acc, out = None, None
    for c in range(calls):
        dr = draws[c] if draws is not None else draw_direct(scene, h * w, generator, o.device, lead=(per,))
        out = render_spp(scene, o, d, per, draws=dr, config=RenderConfig(reparam="soft"), remat=False)
        acc = out["rgb"] if acc is None else acc + out["rgb"]
    return (acc / calls).reshape(h, w, 3), out["hit"].reshape(h, w, 1).float()


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(prog="gen_data")
    ap.add_argument("--object", type=str, default="sphere",
                    help="'sphere' | 'box' | 'composite' | path to .npy SDF volume")
    ap.add_argument("--albedo", choices=["const", "bands"], default="const",
                    help="GT albedo: constant 0.6 or spatially-varying bands")
    ap.add_argument("--envmap", type=Path, default=None)
    ap.add_argument("--n-views", type=int, default=100)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--radius", type=float, default=2.4)
    ap.add_argument("--n-rotations", type=int, default=1,
                    help="turntable light rotations (per-frame rotation tags)")
    ap.add_argument("--path-type", choices=["random", "spiral"], default="random")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true", help="skip views whose EXR already exists (crash resume)")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # the environment
    if args.envmap is not None:
        img = np.load(args.envmap) if args.envmap.suffix == ".npy" else exr.read_exr(args.envmap)
    else:
        img = _procedural_envmap()
    img = np.asarray(img[..., :3], np.float32)
    exr.write_exr(out / "env.exr", img)

    # turntable light rotations: turning the light about +y by angle a is a
    # horizontal roll of the equirect envmap
    rot_angles = [i * 360.0 / args.n_rotations for i in range(args.n_rotations)]
    rot_envs = []
    for a in rot_angles:
        rolled = np.roll(img, int(round(a / 360.0 * img.shape[1])) % img.shape[1], axis=1)
        rot_envs.append(EnvmapEmitter.create(torch.as_tensor(rolled, device=dev)))
        if args.n_rotations > 1:
            exr.write_exr(out / f"env_{int(a)}.exr", rolled)

    # the object and its ground truth, beside the dataset: chamfer
    # evaluation extracts the GT mesh from gt_sdf.npy through the exporter
    sdf, albedo = gt_volumes(args.object, args.albedo)
    np.save(out / "gt_sdf.npy", sdf)
    np.save(out / "gt_albedo.npy", albedo)
    scene = SdfScene.create(sdf_res=int(sdf.shape[0]), tex_res=albedo.shape[0], init_albedo=0.6, device=dev)
    scene = scene.replace(sdf=torch.as_tensor(sdf, device=dev), albedo=torch.as_tensor(albedo, device=dev))

    focal = 0.5 * args.width / np.tan(0.35)
    h, w, n = args.height, args.width, args.n_views
    c2ws, c2ws_render, frame_rots = camera_poses(n, args.radius, args.path_type, rot_angles, args.seed)
    cams = Cameras(camera_to_worlds=torch.as_tensor(np.stack(c2ws_render)[:, :3], device=dev),
                   fx=torch.full((n,), focal, device=dev), fy=torch.full((n,), focal, device=dev),
                   cx=torch.full((n,), w / 2, device=dev), cy=torch.full((n,), h / 2, device=dev),
                   width=w, height=h)

    generator = torch.Generator(device=dev).manual_seed(args.seed)
    per, calls = spp_calls(args.spp)
    frames = []
    for i in range(n):
        name = f"r_{i:04d}.exr"
        sc = scene.replace(envmap=rot_envs[frame_rots[i]])
        if args.resume and (out / name).exists():
            for _ in range(calls):  # the draws a render would take
                draw_direct(sc, h * w, generator, dev, lead=(per,))
        else:
            rgb, mask = render_view(sc, cams, i, args.spp, generator)
            exr.write_exr(out / name, torch.cat([rgb, mask], dim=-1).cpu().numpy())
            if i % 10 == 0:
                print(f"rendered {i}/{n}", flush=True)
        # the tag is the turntable angle in degrees (the reference's convention)
        frames.append({"file_path": name, "transform_matrix": c2ws[i].tolist(),
                       "rotation": int(rot_angles[frame_rots[i]])})

    meta = {
        "fl_x": focal, "fl_y": focal, "w": w, "h": h,
        "cx": w / 2, "cy": h / 2,
        "envmap": "env.exr",
        "object_aabb": object_box(sdf),
        "frames": frames,
    }
    with open(out / "transforms.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"dataset written to {out}")
    return out


if __name__ == "__main__":
    main()
