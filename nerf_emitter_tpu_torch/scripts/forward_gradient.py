"""Forward-gradient validation CLI: the derivative image of a render along
one scene parameter against central finite differences (port of
nerf_emitter_tpu/scripts/forward_gradient.py).

The parameter is a translation of the SDF (`x|y|z`, resampled at shifted
coordinates), an offset of the albedo (`rho`), of the roughness (`r`) or
of the SDF values (`eps`). The render is the port's `render_spp` with the
default `RenderConfig` (the warp on), lit by a white envmap; both sides use
the same draws, so the finite differences are taken at matched samples.
Writes primal.exr, forward_ad.exr, finite_diff.exr and report.json.

  python -m nerf_emitter_tpu_torch.scripts.forward_gradient \
      --axis x --resolution 64 --spp 16 --out grads/ [--device cuda]

How the tangent is taken. The reference calls `jax.jvp` around
`render_spp`, whose warp (renderer/reparam.py) takes jvps of its own
inside. PyTorch's forward AD does not nest dual levels, and the warp
already opens one, so the outer derivative is taken in reverse mode
instead: with the image I(v) and a free cotangent u, g(u) = <u, dI/dv> is
one backward with `create_graph=True`, and the tangent dI/dv is the
gradient of g with respect to u (a second, double backward). The warp's
jvps stay as they are and the second backward differentiates through
them, as JAX's outer jvp does; the render runs without checkpointing so
the double backward sees one graph. This works on the card and on the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

AXES = ("x", "y", "z", "rho", "r", "eps")


def apply_param(scene, axis: str, value: torch.Tensor):
    """The scene moved by `value` along `axis`."""
    from ..renderer.grid3d import grid_sample

    if axis in ("x", "y", "z"):
        r = scene.sdf.shape[0]
        xs = torch.linspace(0.0, 1.0, r, device=scene.sdf.device)
        pts = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1).reshape(-1, 3)
        shift = torch.eye(3, device=pts.device)["xyz".index(axis)] * value
        return scene.replace(sdf=grid_sample(scene.sdf, pts - shift).reshape(r, r, r, 1))
    if axis == "eps":
        return scene.replace(sdf=scene.sdf + value)
    if axis == "rho":
        return scene.replace(albedo=scene.albedo + value)
    return scene.replace(roughness=scene.roughness + value)


def setup(resolution: int, sdf: Optional[np.ndarray], device):
    """(scene, origins, directions): the reference's white envmap, one
    camera at (0, 0.6, 2.2) looking at the origin, the SDF (default a
    sphere of radius 0.25 at 65^3)."""
    from ..cameras.cameras import Cameras
    from ..data.synthetic import look_at
    from ..renderer.emitters import EnvmapEmitter
    from ..renderer.grid3d import sphere_sdf_grid
    from ..renderer.scene import SdfScene
    from ..renderer.sensors import camera_rays_in_render_space

    res = resolution
    env = EnvmapEmitter.create(torch.ones((16, 32, 3), device=device))
    if sdf is not None:
        grid = torch.as_tensor(np.array(sdf, np.float32), device=device)
        grid = grid[..., None] if grid.dim() == 3 else grid
    else:
        grid = sphere_sdf_grid(65, radius=0.25, device=device)
    scene = SdfScene.create(sdf_res=int(grid.shape[0]), tex_res=8, envmap=env, device=device).replace(sdf=grid)
    c2w = look_at(np.array([0.0, 0.6, 2.2], np.float32), np.zeros(3))
    focal = 0.5 * res / np.tan(0.3)

    def col(v):
        return torch.full((1,), float(v), device=device)

    cams = Cameras(camera_to_worlds=torch.as_tensor(np.asarray(c2w[None, :3], np.float32), device=device),
                   fx=col(focal), fy=col(focal), cx=col(res / 2), cy=col(res / 2), width=res, height=res)
    o, d = camera_rays_in_render_space(cams, 0, res, res, 1.0)
    return scene, o, d


def forward_gradient(scene, o, d, axis: str, spp: int, fd_delta: float, *, generator=None, draws=None):
    """(primal, tangent, finite difference), each (res, res, 3), of the
    render along `axis` at 0, on one set of draws (from `generator`, or
    given as the port's DirectDraws)."""
    from ..renderer.integrator import RenderConfig, draw_direct, render_spp

    res = int(round(o.shape[0] ** 0.5))
    cfg = RenderConfig()
    if draws is None:
        draws = draw_direct(scene, o.shape[0], generator, o.device, lead=(spp,))

    def render_value(value):
        out = render_spp(apply_param(scene, axis, value), o, d, spp, draws=draws, config=cfg, remat=False)
        return out["rgb"].reshape(res, res, 3)

    with torch.enable_grad():
        value = torch.zeros((), device=o.device, requires_grad=True)
        primal = render_value(value)
        cotangent = torch.zeros_like(primal, requires_grad=True)
        (g,) = torch.autograd.grad(primal, value, grad_outputs=cotangent, create_graph=True)
        (tangent,) = torch.autograd.grad(g, cotangent)
    with torch.no_grad():
        h = torch.tensor(fd_delta, device=o.device)
        fd = (render_value(h) - render_value(-h)) / (2 * fd_delta)
    return primal.detach(), tangent.detach(), fd


def main(argv=None, draws=None) -> dict:
    """The CLI; `draws` (the port's DirectDraws) replaces the draws made
    from a generator seeded 0. Returns the report."""
    ap = argparse.ArgumentParser(prog="forward_gradient")
    ap.add_argument("--axis", choices=AXES, default="x",
                    help="translation xyz, albedo rho, roughness r, sdf offset eps")
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--fd-delta", type=float, default=2e-3)
    ap.add_argument("--sdf-volume", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=Path("forward_gradient_out"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..utils import exr
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    sdf = np.load(args.sdf_volume) if args.sdf_volume is not None else None
    scene, o, d = setup(args.resolution, sdf, device)
    gen = torch.Generator(device=device).manual_seed(0)
    primal, tangent, fd = forward_gradient(scene, o, d, args.axis, args.spp, args.fd_delta, generator=gen,
                                           draws=draws)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t, f = tangent.cpu().numpy(), fd.cpu().numpy()
    exr.write_exr(out_dir / "primal.exr", primal.cpu().numpy())
    exr.write_exr(out_dir / "forward_ad.exr", t)
    exr.write_exr(out_dir / "finite_diff.exr", f)
    denom = np.abs(f).mean() + 1e-6
    report = {
        "axis": args.axis,
        "mean_abs_ad": float(np.abs(t).mean()),
        "mean_abs_fd": float(np.abs(f).mean()),
        "mean_rel_error": float(np.abs(t - f).mean() / denom),
    }
    (out_dir / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
