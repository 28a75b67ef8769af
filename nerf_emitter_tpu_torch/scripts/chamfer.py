"""Chamfer-distance CLI: geometry accuracy between two meshes (port of
nerf_emitter_tpu/scripts/chamfer.py).

    python -m nerf_emitter_tpu_torch.scripts.chamfer mesh_a.ply mesh_b.ply \
        [--n-points 250000] [--largest-component] [--output-path chamfer.json] [--device cuda]

Points are sampled on both meshes (area-weighted, numpy, the reference's
draws from `default_rng(seed)`), and the symmetric chamfer distance (the
mean squared nearest-neighbour distance each way, summed) is a chunked
minimum over tiles of exact squared differences on the device (CUDA
unless `--device cpu`), where the reference maps a JAX nearest-neighbour
over the points.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device


def sample_mesh_points(
    verts: np.ndarray, faces: np.ndarray, n_points: int, seed: int = 0
) -> np.ndarray:
    """Area-weighted uniform surface sampling."""
    rng = np.random.default_rng(seed)
    tri = verts[faces]  # (F, 3, 3)
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    p = area / max(area.sum(), 1e-12)
    idx = rng.choice(len(faces), n_points, p=p)
    u = rng.random((n_points, 1))
    v = rng.random((n_points, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    t = tri[idx]
    return (t[:, 0] * (1 - u - v) + t[:, 1] * u + t[:, 2] * v).astype(np.float32)


def nearest_sq_dist(x: torch.Tensor, y: torch.Tensor, chunk: int) -> torch.Tensor:
    """For each point of x (N, 3), the squared distance to its nearest
    point of y (M, 3): exact differences (no |x|^2 + |y|^2 - 2 x.y, whose
    cancellation loses the small distances), over chunk x chunk tiles."""
    out = []
    for i in range(0, x.shape[0], chunk):
        q = x[i:i + chunk, None, :]
        best = None
        for j in range(0, y.shape[0], chunk):
            d = ((q - y[None, j:j + chunk, :]) ** 2).sum(-1).amin(1)
            best = d if best is None else torch.minimum(best, d)
        out.append(best)
    return torch.cat(out)


def chamfer_distance(a: np.ndarray, b: np.ndarray, chunk: int = 4096, device=None) -> float:
    """Symmetric mean squared chamfer distance between point sets (N, 3)
    and (M, 3), on `device` (None: CUDA)."""
    dev = resolve_device(device)
    at = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    bt = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    return float(nearest_sq_dist(at, bt, chunk).double().mean() + nearest_sq_dist(bt, at, chunk).double().mean())


def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep only the largest connected component (reference option)."""
    parent = np.arange(len(verts))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for tri in faces:
        a = find(tri[0])
        for k in (1, 2):
            b = find(tri[k])
            if a != b:
                parent[b] = a
    roots = np.array([find(i) for i in range(len(verts))])
    vals, counts = np.unique(roots, return_counts=True)
    keep_root = vals[np.argmax(counts)]
    keep = roots == keep_root
    remap = -np.ones(len(verts), np.int64)
    remap[keep] = np.arange(keep.sum())
    fmask = keep[faces].all(axis=1)
    return verts[keep], remap[faces[fmask]].astype(np.int32)



def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="chamfer")
    ap.add_argument("mesh_a", type=Path)
    ap.add_argument("mesh_b", type=Path)
    ap.add_argument("--n-points", type=int, default=2_500_000 // 10)
    ap.add_argument("--clip-min", type=float, nargs=3, default=None)
    ap.add_argument("--clip-max", type=float, nargs=3, default=None)
    ap.add_argument("--largest-component", action="store_true")
    ap.add_argument("--output-path", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..exporter.marching_cubes import read_ply_or_obj

    pts = []
    for path in (args.mesh_a, args.mesh_b):
        v, f = read_ply_or_obj(path)
        if args.largest_component:
            v, f = largest_component(v, f)
        p = sample_mesh_points(v, f, args.n_points)
        if args.clip_min is not None:
            lo = np.asarray(args.clip_min)
            hi = np.asarray(args.clip_max)
            p = p[((p >= lo) & (p <= hi)).all(axis=1)]
        pts.append(p)

    out = {"chamfer": chamfer_distance(pts[0], pts[1], device=dev)}
    print(json.dumps(out))
    if args.output_path:
        args.output_path.write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
