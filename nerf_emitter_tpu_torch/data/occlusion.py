"""Occlusion and background layers for real captures (port of
nerf_emitter_tpu/data/occlusion.py).

Real turntable scenes hold foreground occluders (the capture rig) and a
static background; the SDF render of the object is composited as

    final = occlusion_rgb * occlusion_mask
          + (1 - occlusion_mask) * (render * obj_mask + bg * (1 - obj_mask))

The layers are rendered from the NeRF once at takeover: the segment
between the camera and the object box (CropMode.NEAR) for the occluders,
the segment behind the box (CropMode.FAR2INF) for the background.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cameras.cameras import Cameras
from .scene_box import CropMode, SceneBox


@dataclasses.dataclass
class OcclusionData:
    """Per-train-image layers, on the device."""

    occlusion_rgb: torch.Tensor  # (n, H, W, 3)
    occlusion_mask: torch.Tensor  # (n, H, W, 1) alpha of the foreground occluders
    background_rgb: torch.Tensor  # (n, H, W, 3)


def composite_with_occlusion(render_rgb: torch.Tensor, render_mask: torch.Tensor, occ: OcclusionData,
                             index) -> torch.Tensor:
    """The compositing equation for camera `index`."""
    o_rgb, o_m, bg = occ.occlusion_rgb[index], occ.occlusion_mask[index], occ.background_rgb[index]
    base = render_rgb * render_mask + bg * (1.0 - render_mask)
    return o_rgb * o_m + base * (1.0 - o_m)


def render_occlusion_layers(render_fn, cameras: Cameras, object_aabb, n_cameras: Optional[int] = None
                            ) -> OcclusionData:
    """The NeRF rendered into occluder (NEAR of the object box) and
    background (FAR2INF) layers for each of the first `n_cameras` cameras
    (all by default). render_fn(cameras, cam_idx, aabb_box=...) -> a dict
    with 'rgb' and 'accumulation' images."""
    n = n_cameras if n_cameras is not None else len(cameras)
    box = torch.as_tensor(object_aabb, dtype=torch.float32, device=cameras.camera_to_worlds.device)
    near_box = SceneBox(aabb=box, crop_mode=CropMode.NEAR)
    far_box = SceneBox(aabb=box, crop_mode=CropMode.FAR2INF)
    occ_rgb, occ_m, bgs = [], [], []
    for i in range(n):
        near_out = render_fn(cameras, i, aabb_box=near_box)
        far_out = render_fn(cameras, i, aabb_box=far_box)
        occ_rgb.append(near_out["rgb"])
        occ_m.append(near_out["accumulation"])
        bgs.append(far_out["rgb"])
    return OcclusionData(occlusion_rgb=torch.stack(occ_rgb), occlusion_mask=torch.stack(occ_m),
                         background_rgb=torch.stack(bgs))
