"""The benchmark's inputs, made from the run's seed: camera poses, target
images and masks, orbit cameras, and the NeRF's weights.

The images are the analytic scene of the port's `data/synthetic.py` (a
diffuse sphere of radius 0.35 at the origin under a directional-gradient
HDR environment), rendered here in PyTorch on the device, all views in one
batch. The poses copy two generators: `ring_poses` the synthetic dataset's
ring (`make_synthetic_dataset`), `random_poses` the end-task generator's
`random` path (`scripts/gen_data.camera_poses`). The camera positions are
scaled by the dataparser's `scene_scale` as the instant-ngp parser does.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPHERE_RADIUS = 0.35
SPHERE_ALBEDO = (0.8, 0.4, 0.3)
LIGHT_DIR = np.array([0.5, 0.7, 0.5]) / np.linalg.norm([0.5, 0.7, 0.5])


def look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """An OpenGL camera-to-world (4, 4) at `eye` looking at `target`."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, -fwd, eye
    return c2w


def _eye(radius: float, theta: float, phi: float) -> np.ndarray:
    return (radius * np.array([np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)])).astype(
        np.float32)


def ring_poses(n: int, radius: float, seed: int) -> np.ndarray:
    """The synthetic dataset's ring: view i at azimuth 2 pi i / n, elevation
    0.3 + 0.5 u. (n, 4, 4)."""
    rng = np.random.default_rng(seed)
    return np.stack([look_at(_eye(radius, 2 * np.pi * i / n, 0.3 + 0.5 * rng.random()), np.zeros(3))
                     for i in range(n)])


def random_poses(n: int, radius: float, seed: int) -> np.ndarray:
    """gen_data's `random` path: azimuth uniform in [0, 2 pi), elevation in
    [0.1, 1.2). (n, 4, 4)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        th = rng.uniform(0, 2 * np.pi)
        ph = rng.uniform(0.1, 1.2)
        out.append(look_at(_eye(radius, th, ph), np.zeros(3)))
    return np.stack(out)


def orbit_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """The viewer's orbit camera about the origin (4, 4), in float32 as the
    viewer computes it."""
    target = np.zeros(3, np.float32)
    eye = target + radius * np.array([np.cos(theta) * np.cos(phi), np.sin(phi), np.sin(theta) * np.cos(phi)],
                                     np.float32)
    return look_at(eye, target)


def _env_radiance(dirs: torch.Tensor) -> torch.Tensor:
    light = torch.as_tensor(LIGHT_DIR, dtype=torch.float32, device=dirs.device)
    cos = torch.clamp(dirs @ light, min=0.0)
    lobe = 4.0 * cos**8
    ambient = 0.3 + 0.2 * torch.clamp(dirs[..., 1], min=0.0)
    return torch.stack([lobe + ambient, 0.9 * lobe + ambient, 0.7 * lobe + ambient], dim=-1)


def render_views(c2w: np.ndarray, width: int, height: int, focal: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The analytic scene seen by every pose at once, in the unscaled frame:
    (images (n, H, W, 3) HDR linear, masks (n, H, W, 1): 1 on the sphere)."""
    c2w_t = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(torch.arange(height, device=device) + 0.5, torch.arange(width, device=device) + 0.5,
                            indexing="ij")
    dirs_cam = torch.stack([(xx - width / 2) / focal, -(yy - height / 2) / focal, -torch.ones_like(xx)], -1)
    dirs = torch.einsum("hwj,nij->nhwi", dirs_cam, c2w_t[:, :3, :3])
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    o = c2w_t[:, :3, 3][:, None, None, :]
    b = 2.0 * torch.sum(dirs * o, dim=-1)
    c = torch.sum(o * o, dim=-1) - SPHERE_RADIUS**2
    disc = b * b - 4 * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / 2.0
    hit = (disc > 0) & (t > 0)
    p = o + dirs * torch.where(hit, t, 1.0)[..., None]
    n = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-9)
    light = torch.as_tensor(LIGHT_DIR, dtype=torch.float32, device=device)
    lambert = torch.clamp(n @ light, min=0.0)[..., None]
    sphere_rgb = torch.as_tensor(SPHERE_ALBEDO, dtype=torch.float32, device=device) * (lambert * 2.0 + 0.25)
    images = torch.where(hit[..., None], sphere_rgb, _env_radiance(dirs))
    return images.contiguous(), hit[..., None].float()


def camera_tensors(c2w: np.ndarray, focal: float, width: int, height: int, scene_scale: float, device) -> dict:
    """The dataparser's cameras as tensors: c2w (n, 3, 4) with the positions
    scaled by scene_scale, fx, fy, cx, cy (n,), width, height."""
    m = np.array(c2w, np.float32)
    m[:, :3, 3] *= scene_scale
    n = m.shape[0]

    def full(v):
        return torch.full((n,), float(v), device=device)

    return dict(camera_to_worlds=torch.as_tensor(m[:, :3, :4], device=device), fx=full(focal), fy=full(focal),
                cx=full(width / 2), cy=full(height / 2), width=width, height=height)


def synthetic_focal(width: int) -> float:
    """The synthetic dataset's focal length (~28 degree half field of view)."""
    return 0.5 * width / math.tan(0.25)


HASH_TABLE_SCALE = 1e-4  # Instant-NGP's table init: uniform in +-1e-4


def make_weights(shapes: dict, seed: int, device) -> dict:
    """The NeRF's parameters from the seed, in one normal draw on the device,
    each tensor by its own rule:

    - a hash table (a name ending in `hash_table`, (rows, features)):
      uniform in +-1e-4 (Instant-NGP's init, as the port's `init_table`),
      made from its normals as erf(x / sqrt 2) * 1e-4;
    - any other 2-D tensor (out, in): N(0, 1/in) (the MLPs' lecun normal
      without its truncation; the appearance table's N(0, 1/dim), as the
      port inits them);
    - each 1-D bias: N(0, 0.01^2).

    `shapes` maps name -> shape."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn((total,), generator=g, device=device)
    out, at = {}, 0
    for name, shape in sorted(shapes.items()):
        size = math.prod(shape)
        x = flat[at:at + size].reshape(shape)
        at += size
        if name.endswith("hash_table"):
            out[name] = torch.erf(x / math.sqrt(2.0)) * HASH_TABLE_SCALE
        else:
            out[name] = x / math.sqrt(shape[1]) if len(shape) == 2 else x * 0.01
    return out
