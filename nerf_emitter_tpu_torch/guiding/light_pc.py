"""Light point-cloud extraction from the NeRF (port of
nerf_emitter_tpu/guiding/light_pc.py).

Light-probe rays from the training cameras at 1/downscale resolution, or
from a spherical rig, clipped with FAR2INF so the object box is skipped;
per ray the model's `point_lights` (luminance, contrib depth, brightness
gradient). The rays of all cameras are one list, cut into chunks of
`chunk` rays, one `point_lights` call each: a call's host cost (thousands
of launches) hardly depends on its rays, so few large calls keep the
device busy. `compensate_pc` keeps the points brighter than the mean as
emissive cluster candidates.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cameras.cameras import Cameras, make_spherical_rig
from ..data.scene_box import CropMode, SceneBox
from ..utils import profiler


def extract_light_point_cloud(
    model,
    cameras: Cameras,
    *,
    object_aabb=None,
    downscale: int = 4,
    chunk: int = 8192,
    use_spherical_rig: bool = False,
    rig_center=None,
    rig_res: tuple[int, int] = (512, 256),
) -> dict[str, torch.Tensor]:
    """Render light-probe rays -> points (M, 3) = o + d depth, luminance
    (M,), rgb (M, 3), brightness_grad (M,), over all cameras x pixels in
    row-major pixel order, from the model's own parameters (the reference's
    `params` argument is the model here). Runs on the model's device; the
    probes carry no autograd graph. Memory grows with `chunk`: 8,192 rays
    of the `freq` field at (256, 96, 48) samples take 5.6 GB of an H100
    above the model. Up to 8,192 rays a call the probes there equal those
    of one call per camera bit for bit; at 16,384 they round differently,
    and the GMM fit on them can land in another optimum."""
    dev = model.device
    if use_spherical_rig:
        center = torch.zeros(3, device=dev) if rig_center is None else torch.as_tensor(rig_center, device=dev)
        cams = make_spherical_rig(center, width=rig_res[0], height=rig_res[1])
    else:
        cams = Cameras(
            camera_to_worlds=cameras.camera_to_worlds.to(dev), fx=cameras.fx.to(dev) / downscale,
            fy=cameras.fy.to(dev) / downscale, cx=cameras.cx.to(dev) / downscale,
            cy=cameras.cy.to(dev) / downscale, width=cameras.width // downscale,
            height=cameras.height // downscale, camera_type=cameras.camera_type,
        )
    h, w = cams.height, cams.width
    box = None
    if object_aabb is not None:
        box = SceneBox(aabb=torch.as_tensor(object_aabb, dtype=torch.float32, device=dev),
                       crop_mode=CropMode.FAR2INF)
    yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    # the reference's row order: camera-major, row-major pixels within each camera
    coords = torch.stack([yy, xx], dim=-1).reshape(-1, 2).repeat(len(cams), 1)
    cam_idx = torch.arange(len(cams), device=dev).repeat_interleave(h * w)

    outs = {"points": [], "luminance": [], "rgb": [], "brightness_grad": []}
    with torch.no_grad(), profiler.span("guiding.probes"):
        for start in range(0, coords.shape[0], chunk):
            co, idx = coords[start:start + chunk], cam_idx[start:start + chunk]
            profiler.count("guiding.probe_rays", co.shape[0])
            profiler.count("guiding.probe_calls", 1)
            rays = cams.generate_rays(idx, co, nears=0.05, fars=1e3, aabb_box=box)
            out = model.point_lights(rays)
            outs["points"].append(rays.origins + rays.directions * out["depth"])
            for k in ("luminance", "rgb", "brightness_grad"):
                outs[k].append(out[k])
    return {k: torch.cat(v) for k, v in outs.items()}


def compensate_pc(points: torch.Tensor, luminance: torch.Tensor, max_points: int = 32768,
                  mean_mult: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """weights = max(lum - mean_mult mean(lum), 0); keep the `max_points`
    heaviest (ties in any order). Returns (points (M, 3), weights (M,)),
    padded with zero-weight points when fewer are bright."""
    w = torch.clamp(luminance - mean_mult * torch.mean(luminance), min=0.0)
    m = min(max_points, w.shape[0])
    top_w, top_i = torch.topk(w, m)
    return points[top_i], top_w
