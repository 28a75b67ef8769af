"""Image datasets on the device and pixel-batch sampling (port of
nerf_emitter_tpu/data/datamanager.py).

The whole image stack of a split is sent to the device once; every train
step draws its pixel batch there from an explicit `torch.Generator`, with
no host-to-device traffic per step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cameras.cameras import Cameras
from ..cameras.rays import RayBundle


@dataclasses.dataclass
class ImageDataset:
    """One split's images and cameras, all tensors on one device."""

    cameras: Cameras
    images: torch.Tensor  # (n, H, W, 3) float32, linear if HDR
    masks: Optional[torch.Tensor] = None  # (n, H, W, 1) float32 in [0, 1]
    rotation_ids: Optional[torch.Tensor] = None  # (n,) int64
    is_hdr: bool = True


def sample_pixel_batch(
    generator: torch.Generator,
    images: torch.Tensor,
    num_rays: int,
    masks: Optional[torch.Tensor] = None,
    masked_sampling: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uniformly sample (camera index, (y, x)) pixels; returns
    (cam (R,), coords (R, 2), rgb (R, 3), mask (R, 1)). `generator` lives
    on the images' device.

    masked_sampling biases the draw toward in-mask pixels by four rounds of
    rejection: each round redraws the pixels that fall outside the mask
    (the loss masking keeps the estimate exact)."""
    n, h, w = images.shape[:3]
    dev = images.device

    def draw():
        cam = torch.randint(0, n, (num_rays,), generator=generator, device=dev)
        yx = torch.stack([torch.randint(0, h, (num_rays,), generator=generator, device=dev),
                          torch.randint(0, w, (num_rays,), generator=generator, device=dev)], dim=-1)
        return cam, yx

    cam, yx = draw()
    if masked_sampling and masks is not None:
        for _ in range(4):
            inside = masks[cam, yx[:, 0], yx[:, 1], 0] > 0.5
            cam2, yx2 = draw()
            cam = torch.where(inside, cam, cam2)
            yx = torch.where(inside[:, None], yx, yx2)
    rgb = images[cam, yx[:, 0], yx[:, 1]]
    mask = (masks[cam, yx[:, 0], yx[:, 1]] if masks is not None
            else torch.ones((num_rays, 1), dtype=images.dtype, device=dev))
    return cam, yx, rgb, mask


def generate_train_rays(
    dataset_cameras: Cameras,
    cam_idx: torch.Tensor,
    coords: torch.Tensor,
    generator: Optional[torch.Generator],
    *,
    near: float,
    far: float,
    aabb_box=None,
    pose_deltas=None,
) -> RayBundle:
    """Rays through the sampled pixels, jittered uniformly inside each
    pixel when a generator is given (its centre otherwise)."""
    jitter = (None if generator is None else
              torch.rand((coords.shape[0], 2), generator=generator, device=coords.device))
    return dataset_cameras.generate_rays(cam_idx, coords, nears=near, fars=far, aabb_box=aabb_box,
                                         jitter=jitter, pose_deltas=pose_deltas)
