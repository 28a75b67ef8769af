"""Render CLI: novel views, relighting videos, envmap probes (port of
nerf_emitter_tpu/scripts/render.py).

    python -m nerf_emitter_tpu_torch.scripts.render <subcommand> \
        --load-config outputs/lego/sdf-nerfacto/config.json [--spp 64] [--output-path renders] [--device cuda]

- `eval`: every eval view through the pipeline's serving path (the SDF
  scene lit by the NeRF, or the NeRF before the takeover), beside its
  ground truth;
- `rotate-light`: one camera, the emitter turned about +y through the
  object's centre frame by frame (the emitter query's points and
  directions rotated);
- `envmap`: the NeRF rendered into an equirect probe at a point (the
  spherical sensor, `make_spherical_rig`);
- `camera-path`: a keyframe JSON (`--camera-path-file`: rotations slerped,
  positions and fields of view lerped) or an orbit of the scene centre;
- `interpolate`: a smooth path through the eval cameras;
- `spiral`: an orbit about the first camera's look-at point with a
  vertical and radial sweep;
- `stroke`: a drawn pixel stroke unprojected through the rendered depth
  into a camera path (JSON).

HDR frames are written as EXR, LDR ones as PNG (utils/video.write_png);
`--video` also muxes the sRGB frames into an uncompressed AVI
(utils/video.write_avi). The frames for the video are clipped to [0, 1]
before 8-bit rounding. `--denoise` applies the joint bilateral filter, or
with `--denoise-mode learned` the per-scene learned denoiser
(renderer/learned_denoise.py), fitted on first use on noise2noise pairs of
training views (NerfEmitterPipeline.fit_scene_denoiser, from a generator
seeded 17).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import torch

from ..cameras.cameras import Cameras
from ..utils.device import resolve_device
from ..utils.math import linear_to_srgb
from ..utils.video import to_uint8, write_avi, write_png

def _load(args):
    from ..configs.cli import load_config
    from ..engine.trainer import Trainer

    config = load_config(args.load_config)
    config.device = str(resolve_device(args.device))
    trainer = Trainer(config)
    trainer.setup()
    try:
        trainer.load_checkpoint(args.checkpoint_step)
    except FileNotFoundError:
        print("warning: no checkpoint found; rendering fresh init")
    return trainer


def _generator(trainer) -> torch.Generator:
    return torch.Generator(device=trainer.device).manual_seed(0)


def _save_image(path: Path, rgb, is_hdr: bool) -> np.ndarray:
    """Write EXR (HDR) or PNG; returns the sRGB-tonemapped uint8 frame
    either way (for video muxing)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    rgb = torch.as_tensor(rgb).detach().float().cpu()
    frame = to_uint8(linear_to_srgb(rgb).numpy())
    if is_hdr:
        from ..utils import exr

        exr.write_exr(path.with_suffix(".exr"), rgb.numpy())
    else:
        write_png(path.with_suffix(".png"), frame)
    return frame


def _maybe_mux(args, frames: list, out_dir: Path, name: str) -> None:
    if args.video and frames:
        p = write_avi(out_dir / f"{name}.avi", frames, fps=args.fps)
        print(f"muxed {len(frames)} frames -> {p}")


def _cameras(c2ws: list, fx, fy, cx, cy, width: int, height: int, device) -> Cameras:
    n = len(c2ws)

    def col(v):
        return torch.as_tensor(np.broadcast_to(np.asarray(v, np.float32), (n,)).copy(), device=device)

    return Cameras(camera_to_worlds=torch.as_tensor(np.stack(c2ws).astype(np.float32), device=device),
                   fx=col(fx), fy=col(fy), cx=col(cx), cy=col(cy), width=width, height=height)


def _like_dataset(ds, c2ws: list):
    """Cameras at c2ws with the first dataset camera's intrinsics."""
    c = ds.cameras
    return _cameras(c2ws, float(c.fx[0]), float(c.fy[0]), float(c.cx[0]), float(c.cy[0]), c.width, c.height,
                    c.camera_to_worlds.device)


def cmd_eval(args):
    trainer = _load(args)
    ds = trainer.eval_dataset or trainer.dataset
    gen = _generator(trainer)
    out_dir = Path(args.output_path)
    for i in range(ds.images.shape[0]):
        out = trainer.pipeline.render_camera_outputs(ds, i, gen, spp=args.spp, spp_per_batch=args.spp_per_batch,
                                                     denoise=args.denoise)
        _save_image(out_dir / f"render_{i:04d}", out["rgb"], ds.is_hdr)
        _save_image(out_dir / f"gt_{i:04d}", ds.images[i], ds.is_hdr)
    print(f"wrote {ds.images.shape[0]} renders to {out_dir}")


def rotated_emitter(base_emitter, angle: float, center=(0.5, 0.5, 0.5)):
    """base_emitter with its query rays turned by `angle` about +y through
    `center` (render space): x -> R (x - c) + c, d -> R d (the reference's
    set_light_axis_angle, mitsuba_sdf.py:1230-1233)."""
    c, s = math.cos(angle), math.sin(angle)
    rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    ctr = torch.tensor(center, dtype=torch.float32)

    def emitter(x, d):
        r, o = rot.to(x.device), ctr.to(x.device)
        return base_emitter((x - o) @ r.T + o, d @ r.T)

    return emitter


@torch.no_grad()
def cmd_rotate_light(args):
    """Relight video: the camera fixed, the emitter turned about +y."""
    trainer = _load(args)
    pipeline = trainer.pipeline
    if pipeline.sdf_state is None:
        raise RuntimeError("rotate-light needs an SDF checkpoint")
    ds = trainer.dataset
    cams = ds.cameras
    h, w = cams.height, cams.width
    from ..renderer.integrator import render_spp
    from ..renderer.learned_denoise import apply_denoiser
    from ..renderer.sensors import camera_rays_in_render_space
    from ..renderer.spp_schedule import bilateral_denoise

    base_emitter = pipeline._emitter_fn_of(pipeline.model)
    # serving needs no gradient: the soft silhouette is primal-identical to the warp
    serve_cfg = dataclasses.replace(pipeline.render_config, reparam="soft")
    o, d = camera_rays_in_render_space(cams, args.camera_index, h, w, pipeline.config.scene_scale)
    gen = _generator(trainer)
    out_dir = Path(args.output_path)
    frames: list = []
    for fi in range(args.n_frames):
        emitter = rotated_emitter(base_emitter, 2.0 * math.pi * fi / args.n_frames)
        out = render_spp(pipeline.sdf_state.scene, o, d, args.spp, gen, emitter_fn=emitter, config=serve_cfg,
                         remat=False)
        rgb, normal, depth = out["rgb"].reshape(h, w, 3), out["normal"].reshape(h, w, 3), out["depth"].reshape(h, w, 1)
        if args.denoise == "learned":
            if pipeline._denoiser_params is None:
                pipeline.fit_scene_denoiser(torch.Generator(device=trainer.device).manual_seed(17), ds)
            rgb = apply_denoiser(pipeline._denoiser_params, rgb, normal, depth, pipeline._denoiser_config)
        elif args.denoise:
            rgb = bilateral_denoise(rgb, normal=normal, depth=depth)
        frames.append(_save_image(out_dir / f"frame_{fi:04d}", rgb, ds.is_hdr))
    print(f"wrote {args.n_frames} relit frames to {out_dir}")
    _maybe_mux(args, frames, out_dir, "rotate_light")


def cmd_envmap(args):
    """Render the NeRF into an equirect probe (spherical sensor)."""
    trainer = _load(args)
    pipeline = trainer.pipeline
    from ..cameras.cameras import make_spherical_rig
    from ..engine.train_loop import make_render_fn

    rig = make_spherical_rig(torch.tensor([args.cx, args.cy, args.cz], device=trainer.device), width=args.width,
                             height=args.height)
    render = make_render_fn(pipeline.model, pipeline.train_config, chunk=4096)
    out = render(rig, 0, args.height, args.width)
    _save_image(Path(args.output_path) / "envmap", out["rgb"], True)
    print("wrote envmap probe")


def cmd_camera_path(args):
    """A keyframe JSON (`--camera-path-file`: {"keyframes": [{"c2w": 3x4,
    "fov_deg": f}, ...], "n_frames": n}, slerped and lerped into n poses)
    or the default orbit of the scene centre."""
    trainer = _load(args)
    ds = trainer.dataset
    from ..data.synthetic import look_at

    if args.camera_path_file:
        with open(args.camera_path_file) as f:
            spec = json.load(f)
        keys = spec["keyframes"]
        n = int(spec.get("n_frames", args.n_frames))
        kf_c2w = [np.asarray(k["c2w"], np.float32) for k in keys]
        kf_fov = [float(k.get("fov_deg", 40.0)) for k in keys]
        if len(keys) == 1:
            c2ws, fovs = [kf_c2w[0]] * n, [kf_fov[0]] * n
        else:
            c2ws, fovs = [], []
            for i in range(n):
                u = i / max(n - 1, 1) * (len(keys) - 1)
                a = min(int(u), len(keys) - 2)
                t = u - a
                rot = _slerp(kf_c2w[a][:, :3], kf_c2w[a + 1][:, :3], t)
                pos = (1 - t) * kf_c2w[a][:, 3] + t * kf_c2w[a + 1][:, 3]
                c2ws.append(np.concatenate([rot, pos[:, None]], axis=1).astype(np.float32))
                fovs.append((1 - t) * kf_fov[a] + t * kf_fov[a + 1])
        w, h = ds.cameras.width, ds.cameras.height
        f = [0.5 * w / np.tan(np.deg2rad(fv) / 2.0) for fv in fovs]
        cams = _cameras(c2ws, f, f, w / 2.0, h / 2.0, w, h, trainer.device)
        _render_path(trainer, ds, cams, args, "path")
        return

    r = float(torch.linalg.norm(ds.cameras.camera_to_worlds[0, :3, 3]))
    c2ws = []
    for i in range(args.n_frames):
        th = 2 * np.pi * i / args.n_frames
        eye = r * np.array([np.cos(th), 0.4, np.sin(th)], np.float32)
        c2ws.append(look_at(eye, np.zeros(3))[:3])
    _render_path(trainer, ds, _like_dataset(ds, c2ws), args, "path")


def _render_path(trainer, ds, cams, args, tag: str) -> None:
    """Every camera of `cams` through the pipeline's serving path: frames
    (+ optional AVI)."""
    from ..data.datamanager import ImageDataset

    path_ds = ImageDataset(cameras=cams, images=ds.images[:1], is_hdr=ds.is_hdr)
    gen = _generator(trainer)
    out_dir = Path(args.output_path)
    frames: list = []
    n = len(cams)
    for i in range(n):
        out = trainer.pipeline.render_camera_outputs(path_ds, i, gen, spp=args.spp, spp_per_batch=args.spp_per_batch,
                                                     denoise=args.denoise)
        frames.append(_save_image(out_dir / f"{tag}_{i:04d}", out["rgb"], ds.is_hdr))
    print(f"wrote {n} {tag} frames to {out_dir}")
    _maybe_mux(args, frames, out_dir, tag)


def _slerp(r0: np.ndarray, r1: np.ndarray, t: float) -> np.ndarray:
    """Spherical interpolation of two rotation matrices via quaternions."""
    def to_quat(m):
        w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
        if w > 1e-6:
            return np.array([w, (m[2, 1] - m[1, 2]) / (4 * w),
                             (m[0, 2] - m[2, 0]) / (4 * w),
                             (m[1, 0] - m[0, 1]) / (4 * w)])
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2.0
        q = np.zeros(4)
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
        return q

    q0, q1 = to_quat(r0), to_quat(r1)
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    th = np.arccos(d)
    if th < 1e-5:
        q = (1 - t) * q0 + t * q1
    else:
        q = (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def interpolate_poses(src: np.ndarray, n_frames: int) -> list:
    """A smooth path through the (n, 3, 4) cameras src: slerped rotations
    and lerped positions between consecutive cameras, n_frames // (n - 1)
    poses per gap (the reference's render.py:808-818)."""
    n_src = src.shape[0]
    if n_src < 2:
        raise ValueError(f"interpolate needs at least two cameras; the split has {n_src}")
    per = max(1, n_frames // (n_src - 1))
    c2ws = []
    for i in range(n_src - 1):
        for j in range(per):
            t = j / per
            m = np.eye(3, 4, dtype=np.float32)
            m[:3, :3] = _slerp(src[i, :3, :3], src[i + 1, :3, :3], t)
            m[:3, 3] = (1 - t) * src[i, :3, 3] + t * src[i + 1, :3, 3]
            c2ws.append(m)
    return c2ws


def cmd_interpolate(args):
    """A smooth path through the eval cameras."""
    trainer = _load(args)
    ds = trainer.eval_dataset or trainer.dataset
    c2ws = interpolate_poses(ds.cameras.camera_to_worlds[:, :3].cpu().numpy(), args.n_frames)
    _render_path(trainer, ds, _like_dataset(ds, c2ws), args, "interp")


def spiral_poses(c0: np.ndarray, n_frames: int) -> list:
    """Poses orbiting the origin from the camera c0 (3, 4): a full turn
    with a slow vertical oscillation and radius sweep."""
    from ..data.synthetic import look_at

    eye0 = c0[:3, 3]
    r0 = float(np.linalg.norm(eye0))
    c2ws = []
    for i in range(n_frames):
        t = i / max(1, n_frames)
        th = np.arctan2(eye0[2], eye0[0]) + 2 * np.pi * t
        rad = r0 * (1.0 + 0.15 * np.sin(4 * np.pi * t))
        y = eye0[1] + 0.25 * r0 * np.sin(2 * np.pi * t)
        eye = np.array([rad * np.cos(th), y, rad * np.sin(th)], np.float32)
        c2ws.append(look_at(eye, np.zeros(3))[:3])
    return c2ws


def cmd_spiral(args):
    """A spiral about the first eval camera's look-at point."""
    trainer = _load(args)
    ds = trainer.eval_dataset or trainer.dataset
    c2ws = spiral_poses(ds.cameras.camera_to_worlds[0, :3].cpu().numpy(), args.n_frames)
    _render_path(trainer, ds, _like_dataset(ds, c2ws), args, "spiral")


def cmd_stroke(args):
    """A stroke ({"camera_index": i, "pixels": [[y, x], ...]}) -> a camera
    path: the pixels unprojected through the rendered depth into 3D, and a
    sensor at each point looking at the origin (the reference's
    StrokeToCameraXml, render.py:716-805)."""
    trainer = _load(args)
    pipeline = trainer.pipeline
    ds = trainer.dataset
    cams = ds.cameras
    with open(args.stroke_path) as f:
        stroke = json.load(f)
    ci = int(stroke.get("camera_index", args.camera_index))
    out = pipeline.render_camera_outputs(ds, ci, _generator(trainer), spp=args.spp)
    depth = out["depth"].reshape(cams.height, cams.width)
    pix = torch.as_tensor(stroke["pixels"], dtype=torch.long, device=trainer.device)
    bundle = cams.generate_rays(torch.full((pix.shape[0],), ci, dtype=torch.long, device=trainer.device), pix)
    d_at = depth[pix[:, 0], pix[:, 1]]
    if pipeline.sdf_state is not None:
        # the SDF's depth is in render space: to a world distance
        d_at = d_at * 2.0 * pipeline.config.scene_scale
    pts = (bundle.origins + bundle.directions * d_at[:, None]).cpu().numpy()
    path = {"points": pts.tolist(),
            "camera_path": [{"position": p.tolist(), "look_at": [0.0, 0.0, 0.0]} for p in pts]}
    out_path = Path(args.output_path).with_suffix(".json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(path, f, indent=1)
    print(f"stroke unprojected to {len(pts)} points -> {out_path}")


COMMANDS = {
    "eval": cmd_eval,
    "rotate-light": cmd_rotate_light,
    "envmap": cmd_envmap,
    "camera-path": cmd_camera_path,
    "interpolate": cmd_interpolate,
    "spiral": cmd_spiral,
    "stroke": cmd_stroke,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="render")
    subs = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in COMMANDS.items():
        sub = subs.add_parser(name)
        sub.add_argument("--load-config", type=Path, required=True)
        sub.add_argument("--output-path", type=Path, default=Path("renders"))
        sub.add_argument("--spp", type=int, default=64)
        sub.add_argument("--checkpoint-step", type=int, default=None)
        sub.add_argument("--camera-index", type=int, default=0)
        sub.add_argument("--n-frames", type=int, default=60)
        sub.add_argument("--width", type=int, default=1024)
        sub.add_argument("--height", type=int, default=512)
        sub.add_argument("--cx", type=float, default=0.5)
        sub.add_argument("--cy", type=float, default=0.5)
        sub.add_argument("--cz", type=float, default=0.5)
        sub.add_argument("--stroke-path", type=Path, default=Path("stroke.json"))
        sub.add_argument("--camera-path-file", type=Path, default=None, help="keyframe JSON to render")
        sub.add_argument("--video", action="store_true", help="also mux the frames into an uncompressed AVI")
        sub.add_argument("--fps", type=int, default=24)
        sub.add_argument("--spp-per-batch", type=int, default=64, help="spp per render call (divide_spp)")
        sub.add_argument("--denoise", action="store_true", help="denoise the final renders")
        sub.add_argument("--denoise-mode", choices=("bilateral", "learned"), default="bilateral",
                         help="bilateral: the joint bilateral filter; learned: the per-scene learned denoiser")
        sub.add_argument("--device", default="cuda")
        sub.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    # the pipeline takes denoise False | 'bilateral' | 'learned'
    if args.denoise:
        args.denoise = args.denoise_mode
    args.fn(args)


if __name__ == "__main__":
    main()
