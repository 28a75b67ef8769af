"""Sensors of the SDF renderer (port of nerf_emitter_tpu/renderer/sensors.py):
a camera's pixel rays and an equirectangular fan, mapped into the unit-cube
render space. Cameras keep one convention; only the world -> unit
scale-shift applies (utils/coords.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..cameras.cameras import Cameras
from ..utils import coords
from ..utils.device import id_column


def camera_rays_in_render_space(
    cameras: Cameras,
    cam_index,
    height: int,
    width: int,
    scene_scale: float,
    generator: Optional[torch.Generator] = None,
    *,
    jitter: Optional[torch.Tensor] = None,
    spp_jitter: bool = True,
    rotater=None,
    rot_id=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All pixel rays of camera `cam_index` (an int or a 0-d tensor) ->
    (origins (H*W, 3) in render space, directions (H*W, 3)). A uniform
    scale keeps directions, so they are not renormalised.

    Sub-pixel jitter (H*W, 2): given, or drawn from `generator` when
    spp_jitter; with neither, pixel centres. rotater + rot_id (turntable
    captures): world rays are inverse-rotated into the object's canonical
    frame before the unit-cube mapping."""
    dev = cameras.camera_to_worlds.device
    yy, xx = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij")
    pix = torch.stack([yy, xx], dim=-1).reshape(-1, 2)
    idx = id_column(cam_index, (pix.shape[0],), dev)
    if jitter is None and generator is not None and spp_jitter:
        jitter = torch.rand((pix.shape[0], 2), generator=generator, device=dev)
    bundle = cameras.generate_rays(idx, pix, jitter=jitter)
    o_w, d_w = bundle.origins, bundle.directions
    if rotater is not None and rot_id is not None:
        o_w, d_w = rotater.apply_rays_within(id_column(rot_id, o_w.shape[:1], dev), o_w, d_w)
    return coords.world_to_unit(o_w, scene_scale), d_w


def spherical_rays(center_unit: torch.Tensor, height: int, width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Equirectangular ray fan from a point in render space (the spherical
    sensor) -> (origins (H*W, 3), directions (H*W, 3))."""
    dev = center_unit.device
    ys = (torch.arange(height, device=dev) + 0.5) / height * math.pi
    xs = ((torch.arange(width, device=dev) + 0.5) / width - 0.5) * 2.0 * math.pi
    theta, phi = torch.meshgrid(ys, xs, indexing="ij")
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)], dim=-1).reshape(-1, 3)
    return center_unit.expand(d.shape), d
