"""Mesh -> SDF voxel conversion CLI (port of
nerf_emitter_tpu/scripts/convert_mesh_to_sdf.py).

Voxelises a triangle mesh into a signed distance grid on [0, 1]^3: the
unsigned distance from each node to the nearest triangle on the device, in
chunks of `batch` nodes (the reference's `lax.map`, batch 256); the sign by
ray parity (even-odd crossings along +x) on the host in numpy; then the
port's `renderer/optimize.redistance` with 2r sweeps.

  python -m nerf_emitter_tpu_torch.scripts.convert_mesh_to_sdf \
      mesh.obj --resolution 128 --out sdf.npy [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def point_triangle_distance_batch(pts: torch.Tensor, tri: torch.Tensor, batch: int = 256) -> torch.Tensor:
    """pts (P, 3), tri (T, 3, 3) -> (P,) distance to the nearest triangle:
    the nearest of the clamped interior point and the three edges'
    nearest points (the reference's formula), `batch` points at a time."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab, ac, bc = b - a, c - a, c - b
    bc2 = torch.clamp(torch.sum(bc * bc, -1), min=1e-12)
    out = []
    for p in torch.split(pts, batch):
        p = p[:, None, :]  # (B, 1, 3) against (T, 3)
        ap, bp, cp = p - a, p - b, p - c
        d1, d2 = torch.sum(ab * ap, -1), torch.sum(ac * ap, -1)
        d3, d4 = torch.sum(ab * bp, -1), torch.sum(ac * bp, -1)
        d5, d6 = torch.sum(ab * cp, -1), torch.sum(ac * cp, -1)
        va = d3 * d6 - d5 * d4
        vb = d5 * d2 - d1 * d6
        vc = d1 * d4 - d3 * d2
        denom = torch.clamp(va + vb + vc, min=1e-12)
        v = torch.clamp(vb / denom, 0.0, 1.0)
        w = torch.clamp(vc / denom, 0.0, 1.0)
        q_in = a + v[..., None] * ab + w[..., None] * ac  # interior closest point
        t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-12), 0.0, 1.0)
        t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-12), 0.0, 1.0)
        t_bc = torch.clamp(torch.sum(bc * bp, -1) / bc2, 0.0, 1.0)
        cands = torch.stack([q_in, a + t_ab[..., None] * ab, a + t_ac[..., None] * ac, b + t_bc[..., None] * bc])
        out.append(torch.linalg.vector_norm(cands - p, dim=-1).amin(dim=(0, 2)))
    return torch.cat(out)


def sign_by_parity(pts: np.ndarray, verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """-1 where a ray from the point along +x crosses the mesh an odd
    number of times (Moller-Trumbore, the reference's numpy), else 1. The
    per-triangle terms are computed once, and the points that share a
    (y, z) test together, against only the triangles whose y-z bounding
    box (widened by 1e-6) holds that (y, z): a +x ray misses the others."""
    tri = verts[faces]
    signs = np.ones(len(pts), np.float32)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    d = np.array([1.0, 0.0, 0.0])
    e1 = b - a
    e2 = c - a
    pv = np.cross(d, e2)
    det = np.einsum("td,td->t", e1, pv)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    lo, hi = tri[:, :, 1:].min(1) - 1e-6, tri[:, :, 1:].max(1) + 1e-6
    lines, line_of = np.unique(pts[:, 1:], axis=0, return_inverse=True)
    for k, (y, z) in enumerate(lines):
        near = np.nonzero((lo[:, 0] <= y) & (y <= hi[:, 0]) & (lo[:, 1] <= z) & (z <= hi[:, 1]))[0]
        if len(near) == 0:
            continue
        idx = np.nonzero(line_of.reshape(-1) == k)[0]
        tv = pts[idx][:, None, :] - a[near]  # (P, T', 3)
        u = np.einsum("ptd,td->pt", tv, pv[near]) * inv[near]
        qv = np.cross(tv, e1[near])
        v = (qv @ d) * inv[near]
        t = np.einsum("td,ptd->pt", e2[near], qv) * inv[near]
        hits = ok[near] & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        signs[idx[hits.sum(1) % 2 == 1]] = -1.0
    return signs


def mesh_to_sdf(verts: np.ndarray, faces: np.ndarray, resolution: int, offset: float = 0.0,
                device=None) -> np.ndarray:
    """(r, r, r, 1) float32 SDF of the mesh on the nodes i / (r - 1), on
    `device` (None: CUDA; no CUDA device is an error)."""
    from ..renderer.optimize import redistance
    from ..utils.device import resolve_device

    device = resolve_device(device)

    r = resolution
    xs = np.linspace(0, 1, r, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    tri = torch.as_tensor(np.asarray(verts[faces], np.float32), device=device)
    dist = point_triangle_distance_batch(torch.as_tensor(pts, device=device), tri)
    sign = torch.as_tensor(sign_by_parity(pts, verts, faces), device=device)
    sdf = (sign * dist - offset).reshape(r, r, r, 1)
    return redistance(sdf, n_iters=2 * r).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="convert_mesh_to_sdf")
    ap.add_argument("mesh", type=Path)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--offset", type=float, default=0.0,
                    help="subtract from distances (dilate surface)")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..exporter.marching_cubes import read_ply_or_obj
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    verts, faces = read_ply_or_obj(args.mesh)
    sdf = mesh_to_sdf(verts, faces, args.resolution, args.offset, device)
    np.save(args.out, sdf)
    print(f"wrote {args.out} ({args.resolution}^3)")
    return sdf


if __name__ == "__main__":
    main()
