"""Trilinear voxel grids on [0, 1]^3 (port of nerf_emitter_tpu/renderer/grid3d.py).

A grid is a tensor (Rx, Ry, Rz, C). Nodes sit at i / (R - 1) (cell-vertex
convention) and points outside [0, 1] clamp to the edge. A sample gathers
the eight corners of its cell in one `index_select` (its backward is one
`index_add_`), so it is differentiable in the values and in the points.

`sdf_gradient` is the closed form of the interpolant's spatial gradient,
written in tensor ops so that it is itself differentiable: the shading
normal's gradient reaches the SDF values and the hit point, and the warp
field (reparam.py) takes a jvp through it. The clamp follows `jnp.clip`,
whose derivative is 1/2 on the boundary.
"""

from __future__ import annotations

import math

import torch


def _clip01(p: torch.Tensor) -> torch.Tensor:
    """clip(p, 0, 1) with jnp.clip's derivative (1/2 at either bound)."""
    return torch.minimum(torch.maximum(p, p.new_zeros(())), p.new_ones(()))


def _clip01_grad(p: torch.Tensor) -> torch.Tensor:
    """The derivative of _clip01 at p: 1 inside, 1/2 on a bound, 0 outside."""
    inside = ((p > 0.0) & (p < 1.0)).to(p.dtype)
    edge = ((p == 0.0) | (p == 1.0)).to(p.dtype)
    return inside + 0.5 * edge


def _last_node(like: torch.Tensor, shape):
    """R - 1 per axis: a float for a cubic grid, else a (3,) tensor filled
    on like's device (a host copy of a Python list would synchronise the
    stream)."""
    rx, ry, rz = shape[:3]
    if rx == ry == rz:
        return float(rx - 1)
    return torch.stack([like.new_full((), float(r - 1)) for r in (rx, ry, rz)])


def _cell(values: torch.Tensor, points: torch.Tensor):
    """The eight corner values of each point's cell, (2, 2, 2, ..., C)
    indexed [x, y, z], and the fractional position in the cell (..., 3)."""
    rx, ry, rz, c = values.shape
    res = _last_node(points, values.shape)
    p = _clip01(points) * res
    p0 = torch.clamp(torch.clamp(torch.floor(p), min=0.0), max=res - 1.0)
    frac = p - p0
    # p0 <= R - 2, so the far corner is always one node further; a NaN
    # point takes the cell at node 0 (as XLA's gather does) and its value
    # stays NaN through frac
    i0 = torch.nan_to_num(p0, nan=0.0).long()
    base = (i0[..., 0] * ry + i0[..., 1]) * rz + i0[..., 2]
    ix = torch.stack([base, base + ry * rz])
    ixy = torch.stack([ix, ix + rz], dim=1)
    ixyz = torch.stack([ixy, ixy + 1], dim=2)
    v = values.reshape(-1, c).index_select(0, ixyz.reshape(-1))
    return v.reshape(*ixyz.shape, c), frac


def grid_sample(values: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Trilinear sample: values (Rx, Ry, Rz, C), points (..., 3) -> (..., C)."""
    v, frac = _cell(values, points)
    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    cz = v[:, :, 0] * (1 - fz) + v[:, :, 1] * fz
    cy = cz[:, 0] * (1 - fy) + cz[:, 1] * fy
    return cy[0] * (1 - fx) + cy[1] * fx


def _as4(sdf: torch.Tensor) -> torch.Tensor:
    return sdf if sdf.dim() == 4 else sdf[..., None]


def sdf_eval(sdf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """SDF value at points: sdf (R, R, R) or (R, R, R, 1) -> (...)."""
    return grid_sample(_as4(sdf), points)[..., 0]


def sdf_eval_nearest(sdf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Nearest-node SDF value: one gather per point instead of eight.
    Error bound: half the voxel diagonal for a unit-Lipschitz SDF."""
    g = sdf[..., 0] if sdf.dim() == 4 else sdf
    r = g.shape[0]
    p = torch.clamp(points, 0.0, 1.0) * (r - 1)
    i = torch.clamp(torch.round(p).long(), 0, r - 1)  # clamped after the cast: NaN -> node 0
    flat = (i[..., 0] * r + i[..., 1]) * r + i[..., 2]
    return g.reshape(-1)[flat]


def sdf_gradient(sdf: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Spatial gradient of the trilinear interpolant at points (..., 3), in
    closed form (the reference takes jax.grad of the sample's sum). It is
    linear in the SDF values and differentiable in the points."""
    values = _as4(sdf)
    v, frac = _cell(values, points)
    v = v[..., 0]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    cz = v[:, :, 0] * (1 - fz) + v[:, :, 1] * fz
    cy = cz[:, 0] * (1 - fy) + cz[:, 1] * fy
    dz = v[:, :, 1] - v[:, :, 0]
    dz_y = dz[:, 0] * (1 - fy) + dz[:, 1] * fy
    gz = dz_y[0] * (1 - fx) + dz_y[1] * fx
    dy = cz[:, 1] - cz[:, 0]
    gy = dy[0] * (1 - fx) + dy[1] * fx
    gx = cy[1] - cy[0]
    scale = _clip01_grad(points) * _last_node(points, values.shape)
    return torch.stack([gx, gy, gz], dim=-1) * scale


def sdf_normal(sdf: torch.Tensor, points: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit surface normal: the normalised SDF gradient. rsqrt(max(g.g, eps))
    keeps the backward finite where the gradient is exactly zero (a flat or
    clamped region): g / max(|g|, eps) would give 0/0 there."""
    g = sdf_gradient(sdf, points)
    n2 = torch.sum(g * g, dim=-1, keepdim=True)
    return g * torch.rsqrt(torch.clamp(n2, min=eps))


def _node_points(res: int, device=None) -> torch.Tensor:
    xs = torch.linspace(0.0, 1.0, res, device=device)
    gx, gy, gz = torch.meshgrid(xs, xs, xs, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1)


def upsample_grid(values: torch.Tensor, new_res: int) -> torch.Tensor:
    """Node-aligned (align-corners) trilinear upsample (R, R, R, C) ->
    (new, new, new, C): the interpolated field is unchanged at shared nodes."""
    pts = _node_points(new_res, values.device).reshape(-1, 3)
    return grid_sample(values, pts).reshape(new_res, new_res, new_res, values.shape[-1])


def _centered(res: int, center, device) -> torch.Tensor:
    return _node_points(res, device) - torch.tensor(center, dtype=torch.float32, device=device)


def sphere_sdf_grid(res: int, radius: float = 0.3, center=(0.5, 0.5, 0.5), device=None) -> torch.Tensor:
    """A sphere's SDF on a res^3 grid, (res, res, res, 1)."""
    return (torch.linalg.norm(_centered(res, center, device), dim=-1) - radius)[..., None]


def _box(p: torch.Tensor, half) -> torch.Tensor:
    q = torch.abs(p) - half
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    return outside + torch.clamp(torch.amax(q, dim=-1), max=0.0)


def box_sdf_grid(res: int, half_extent: float = 0.3, center=(0.5, 0.5, 0.5), device=None) -> torch.Tensor:
    """An axis-aligned box's SDF, (res, res, res, 1)."""
    return _box(_centered(res, center, device), half_extent)[..., None]


def composite_sdf_grid(res: int, center=(0.5, 0.5, 0.5), device=None) -> torch.Tensor:
    """The recovery tests' ground-truth object: a smooth union of a sphere
    and a box turned 30 degrees about y, with a cylindrical bore along z
    through the sphere lobe (creases and an occluded concavity)."""
    pts = _centered(res, center, device)
    sph = torch.linalg.norm(pts - pts.new_tensor([-0.05, 0.02, 0.0]), dim=-1) - 0.15
    a = math.radians(30.0)
    c, s = math.cos(a), math.sin(a)
    p = pts - pts.new_tensor([0.07, -0.03, 0.0])
    pb = torch.stack([c * p[..., 0] + s * p[..., 2], p[..., 1], -s * p[..., 0] + c * p[..., 2]], dim=-1)
    box = _box(pb, pts.new_tensor([0.13, 0.10, 0.11]))
    k = 24.0  # smooth-union sharpness (1/k blend radius)
    union = -torch.log(torch.exp(-k * sph) + torch.exp(-k * box)) / k
    cyl = torch.linalg.norm(pts[..., :2] - pts.new_tensor([-0.05, 0.02]), dim=-1) - 0.055
    return torch.maximum(union, -cyl)[..., None]
