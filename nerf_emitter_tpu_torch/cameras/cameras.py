"""Cameras and ray generation (port of nerf_emitter_tpu/cameras/cameras.py):
stacked intrinsics and extrinsics, perspective and equirectangular. The
equirectangular camera backs the light-probe rig (`make_spherical_rig`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..data.scene_box import SceneBox
from ..utils.math import normalize
from .rays import RayBundle

PERSPECTIVE = 0
EQUIRECTANGULAR = 1


def _bounds(v, device) -> torch.Tensor:
    """A near or far bound as a float32 tensor on `device`. A number is
    filled there: copying it from the host would wait for the device."""
    if isinstance(v, (int, float)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass
class Cameras:
    """Stacked cameras; every tensor leads with the camera axis.

    camera_to_worlds (n, 3, 4), OpenGL convention (+x right, +y up, -z
    forward); fx, fy, cx, cy (n,) in pixels; width and height ints."""

    camera_to_worlds: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 0
    height: int = 0
    camera_type: int = PERSPECTIVE

    def __len__(self) -> int:
        return self.camera_to_worlds.shape[0]

    def generate_rays(
        self,
        camera_indices: torch.Tensor,
        pixel_coords: torch.Tensor,
        *,
        nears=0.05,
        fars=1e3,
        aabb_box: Optional[SceneBox] = None,
        jitter: Optional[torch.Tensor] = None,
        pose_deltas: Optional[torch.Tensor] = None,
    ) -> RayBundle:
        """Rays through integer (row, col) pixel coords (N, 2) of cameras
        (N,). jitter (N, 2) in [0, 1) offsets within the pixel (default:
        the centre, 0.5); pose_deltas (n_cams, 3, 4) is added to c2w."""
        idx = camera_indices.long()
        c2w = self.camera_to_worlds[idx]
        if pose_deltas is not None:
            c2w = c2w + pose_deltas[idx]
        fx, fy, cx, cy = self.fx[idx], self.fy[idx], self.cx[idx], self.cy[idx]
        if jitter is None:
            jitter = torch.full(pixel_coords.shape, 0.5, dtype=torch.float32, device=c2w.device)
        y = pixel_coords[..., 0].float() + jitter[..., 0]
        x = pixel_coords[..., 1].float() + jitter[..., 1]
        if self.camera_type == PERSPECTIVE:
            dx = (x - cx) / fx
            dy = -(y - cy) / fy
            dirs_cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
            pixel_area = (1.0 / (fx * fy))[..., None]
        elif self.camera_type == EQUIRECTANGULAR:
            w, h = float(self.width), float(self.height)
            phi = (x / w - 0.5) * 2.0 * math.pi
            theta = y / h * math.pi
            sin_t = torch.sin(theta)
            dirs_cam = torch.stack([sin_t * torch.sin(phi), torch.cos(theta), -sin_t * torch.cos(phi)],
                                   dim=-1)
            pixel_area = ((2.0 * math.pi / w) * (math.pi / h) * sin_t.clamp(min=1e-4))[..., None]
        else:
            raise ValueError(f"unknown camera type {self.camera_type}")
        directions = normalize(torch.einsum("nij,nj->ni", c2w[..., :3, :3], dirs_cam))
        origins = c2w[..., :3, 3]
        shape = (*directions.shape[:-1], 1)
        n, f = (_bounds(v, c2w.device).expand(shape) for v in (nears, fars))
        if aabb_box is not None:
            n, f = aabb_box.clip_near_far(origins, directions, n, f)
        return RayBundle(origins=origins, directions=directions, pixel_area=pixel_area,
                         nears=n, fars=f, camera_indices=idx[..., None])

    def generate_image_rays(self, camera_index: int, **kwargs) -> RayBundle:
        """All rays of one camera, each tensor shaped (H, W, ...)."""
        dev = self.camera_to_worlds.device
        yy, xx = torch.meshgrid(torch.arange(self.height, device=dev),
                                torch.arange(self.width, device=dev), indexing="ij")
        coords = torch.stack([yy, xx], dim=-1).reshape(-1, 2)
        idx = torch.full((coords.shape[0],), camera_index, dtype=torch.long, device=dev)
        rays = self.generate_rays(idx, coords, **kwargs)
        return RayBundle(**{k: None if v is None else v.reshape(self.height, self.width, *v.shape[1:])
                            for k, v in vars(rays).items()})


def make_spherical_rig(center: torch.Tensor, width: int = 4096, height: int = 2048) -> Cameras:
    """One equirectangular camera at `center`: the light-probe rig."""
    center = torch.as_tensor(center, dtype=torch.float32)
    c2w = torch.cat([torch.eye(3, device=center.device), center.reshape(3, 1)], dim=1)[None]
    one = torch.ones(1, device=center.device)
    return Cameras(camera_to_worlds=c2w, fx=one, fy=one, cx=one * (width / 2),
                   cy=one * (height / 2), width=width, height=height, camera_type=EQUIRECTANGULAR)
