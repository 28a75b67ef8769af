"""TSDF fusion: the SDF voxel grid initialised from NeRF depth renders (port
of nerf_emitter_tpu/pipelines/tsdf.py).

Depth images rendered from the training cameras are integrated into a
truncated signed distance volume on the unit cube, which redistancing then
turns into an SDF. Every voxel centre is projected into every camera at
once (a pinhole projection and bilinear depth taps), and the evidence is
summed over the cameras, 2^18 voxels at a time.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cameras.cameras import Cameras
from ..renderer.optimize import redistance
from ..utils import coords


def integrate_tsdf(
    cameras: Cameras,
    depth_images: torch.Tensor,
    res: int = 128,
    scene_scale: float = 1.0,
    truncation: Optional[float] = None,
    chunk: int = 1 << 18,
    object_aabb=None,
) -> torch.Tensor:
    """Fuse depth maps (B, H, W, 1), distances along the ray, into a TSDF on
    the unit cube -> (res, res, res, 1) in unit-cube distances.

    The cameras are OpenGL's (-z forward); a ray depth d becomes a z-depth
    d * z / |p_cam|. A voxel seen in front of a surface, or behind it by
    less than the truncation, averages its clipped distances over the
    views that see it; a voxel never seen within the band is solid (-1)
    when some view sees it behind a surface and free (+1) otherwise.
    object_aabb (2, 3), world: voxels outside the box are free, so the
    volume that the ring of cameras sees only from behind stays empty."""
    h_img, w_img = depth_images.shape[1:3]
    dev = depth_images.device
    if truncation is None:
        truncation = 4.0 / res  # about 4 voxels
    xs = torch.linspace(0.0, 1.0, res, device=dev)
    gx, gy, gz = torch.meshgrid(xs, xs, xs, indexing="ij")
    vox_world = coords.unit_to_world(torch.stack([gx, gy, gz], -1).reshape(-1, 3), scene_scale)

    c2w = cameras.camera_to_worlds
    r_t = c2w[:, :3, :3].transpose(1, 2)  # world -> camera: R^T (p - t)
    r_t_t = torch.einsum("bij,bj->bi", r_t, c2w[:, :3, 3])
    fx, fy, cx, cy = (x[:, None] for x in (cameras.fx, cameras.fy, cameras.cx, cameras.cy))
    b_idx = torch.arange(depth_images.shape[0], device=dev)[:, None]
    depth = depth_images[..., 0]

    def fuse_chunk(vw):
        p_cam = torch.einsum("bij,vj->bvi", r_t, vw) - r_t_t[:, None, :]
        z = -p_cam[..., 2]  # (B, V) depth along the optical axis
        valid = z > 1e-6
        zc = torch.clamp(z, min=1e-6)
        u = fx * p_cam[..., 0] / zc + cx
        v = -fy * p_cam[..., 1] / zc + cy
        inside = valid & (u >= 0) & (u <= w_img - 1) & (v >= 0) & (v <= h_img - 1)
        ui = torch.clamp(u, 0, w_img - 1)
        vi = torch.clamp(v, 0, h_img - 1)
        u0, v0 = torch.floor(ui).long(), torch.floor(vi).long()
        u1, v1 = torch.clamp(u0 + 1, max=w_img - 1), torch.clamp(v0 + 1, max=h_img - 1)
        fu, fv = ui - u0, vi - v0
        d = (depth[b_idx, v0, u0] * (1 - fu) * (1 - fv) + depth[b_idx, v0, u1] * fu * (1 - fv)
             + depth[b_idx, v1, u0] * (1 - fu) * fv + depth[b_idx, v1, u1] * fu * fv)
        d_z = d * zc / torch.clamp(torch.linalg.vector_norm(p_cam, dim=-1), min=1e-6)
        sdf_obs = d_z - z  # + in front of the surface, - behind it
        w_obs = (inside & (sdf_obs > -truncation)).float()
        tsdf_obs = torch.clamp(sdf_obs / truncation, -1.0, 1.0)
        behind = (inside & (sdf_obs <= -truncation)).float()
        return (tsdf_obs * w_obs).sum(0), w_obs.sum(0), behind.sum(0)

    parts = [fuse_chunk(vox_world[s:s + chunk]) for s in range(0, vox_world.shape[0], chunk)]
    num, den, behind = (torch.cat(p) for p in zip(*parts))
    tsdf = torch.where(den > 0, num / torch.clamp(den, min=1e-6),
                       torch.where(behind > 0, -1.0, 1.0))
    if object_aabb is not None:
        box = torch.as_tensor(object_aabb, dtype=torch.float32, device=dev)
        inside_box = torch.all((vox_world > box[0]) & (vox_world < box[1]), dim=-1)
        tsdf = torch.where(inside_box, tsdf, 1.0)
    return (tsdf * truncation / (2.0 * scene_scale)).reshape(res, res, res, 1)


def tsdf_init_sdf(
    cameras: Cameras,
    depth_images: torch.Tensor,
    res: int = 128,
    scene_scale: float = 1.0,
    redistance_iters: int = 100,
    object_aabb=None,
) -> torch.Tensor:
    """TSDF fusion, then eikonal redistancing: the SDF the takeover starts
    from."""
    tsdf = integrate_tsdf(cameras, depth_images, res, scene_scale, object_aabb=object_aabb)
    return redistance(tsdf, n_iters=redistance_iters)
