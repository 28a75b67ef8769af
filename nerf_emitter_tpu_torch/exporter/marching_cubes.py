"""Iso-surface extraction and mesh files (port of
nerf_emitter_tpu/exporter/marching_cubes.py).

The zero level set of an SDF voxel grid becomes a triangle mesh by
marching tetrahedra: each cell splits into 6 tetrahedra whose 16 cases
enumerate in a dozen lines, vectorised over the crossing cells in numpy
(the reference's own tables and extraction, copied). The multi-resolution
evaluation (`upsampled_marching_cubes`) and the vertex texturing
(`sample_vertex_attributes`) sample the grid's trilinear interpolant with
renderer/grid3d.grid_sample on the device the caller names (CUDA unless
asked otherwise); the mesh comes back as host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..renderer.grid3d import grid_sample
from ..utils.device import resolve_device

_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    np.float32,
)

# six tetrahedra covering the cube (all sharing the 0-6 diagonal)
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int32,
)


def _tet_case_tables():
    """For each of the 16 inside-bitmasks of a tet's 4 corners, the list of
    triangles; each triangle vertex is an edge (corner_a, corner_b) to
    interpolate on. Orientation: consistent winding with the normal
    pointing from inside (f<iso) to outside."""
    tris_by_case: list[list[tuple[tuple[int, int], ...]]] = [[] for _ in range(16)]
    for case in range(1, 15):
        inside = [i for i in range(4) if case & (1 << i)]
        outside = [i for i in range(4) if not case & (1 << i)]
        if len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            tris_by_case[case] = [((a, b), (a, c), (a, d))]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            tris_by_case[case] = [((b, a), (d, a), (c, a))]
        else:  # two inside
            a, b = inside
            c, d = outside
            tris_by_case[case] = [
                ((a, c), (a, d), (b, d)),
                ((a, c), (b, d), (b, c)),
            ]
    return tris_by_case


_TET_TRIS = _tet_case_tables()


def marching_cubes(
    sdf: np.ndarray, iso: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """sdf: (Rx, Ry, Rz[, 1]) -> (vertices (V, 3) in [0,1]^3, faces (F, 3))."""
    sdf = np.asarray(sdf, np.float32)
    if sdf.ndim == 4:
        sdf = sdf[..., 0]
    rx, ry, rz = sdf.shape
    nx, ny, nz = rx - 1, ry - 1, rz - 1

    vals = np.empty((nx, ny, nz, 8), np.float32)
    for ci, (cx, cy, cz) in enumerate(_CORNERS.astype(np.int32)):
        vals[..., ci] = sdf[cx : cx + nx, cy : cy + ny, cz : cz + nz]

    # only cells crossing the iso level participate
    vmin = vals.min(-1)
    vmax = vals.max(-1)
    ax, ay, az = np.nonzero((vmin < iso) & (vmax >= iso))
    if ax.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    a_vals = vals[ax, ay, az]  # (A, 8)
    origin = np.stack([ax, ay, az], -1).astype(np.float32)  # (A, 3)
    scale = np.array([nx, ny, nz], np.float32)

    tri_chunks = []
    for tet in _TETS:
        tvals = a_vals[:, tet]  # (A, 4)
        tin = tvals < iso
        case = (
            tin[:, 0].astype(np.int32)
            | tin[:, 1].astype(np.int32) << 1
            | tin[:, 2].astype(np.int32) << 2
            | tin[:, 3].astype(np.int32) << 3
        )
        for c in range(1, 15):
            sel = np.nonzero(case == c)[0]
            if sel.size == 0:
                continue
            for tri in _TET_TRIS[c]:
                pts = []
                for ea, eb in tri:
                    ca, cb = tet[ea], tet[eb]
                    v0 = a_vals[sel, ca]
                    v1 = a_vals[sel, cb]
                    denom = np.where(np.abs(v1 - v0) > 1e-12, v1 - v0, 1.0)
                    t = np.clip((iso - v0) / denom, 0.0, 1.0)
                    p = (
                        origin[sel]
                        + _CORNERS[ca]
                        + t[:, None] * (_CORNERS[cb] - _CORNERS[ca])
                    ) / scale
                    pts.append(p)
                tri_chunks.append(np.stack(pts, axis=1))  # (M, 3, 3)

    all_tris = np.concatenate(tri_chunks)  # (T, 3, 3)
    verts = all_tris.reshape(-1, 3)
    faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)

    # weld duplicate vertices (shared edge interpolants)
    quant = np.round(verts * 1e6).astype(np.int64)
    keys = quant[:, 0] * 73856093 ^ quant[:, 1] * 19349663 ^ quant[:, 2] * 83492791
    _, uniq_idx, inv = np.unique(keys, return_index=True, return_inverse=True)
    verts_w = verts[uniq_idx]
    faces_w = inv[faces].astype(np.int32)
    good = (
        (faces_w[:, 0] != faces_w[:, 1])
        & (faces_w[:, 1] != faces_w[:, 2])
        & (faces_w[:, 0] != faces_w[:, 2])
    )
    return verts_w.astype(np.float32), faces_w[good]


def _sample(values: np.ndarray, points: np.ndarray, device, chunk: int = 1 << 20) -> np.ndarray:
    """grid_sample of a host grid (R, R, R, C) at host points (N, 3) on
    `device`, in chunks of `chunk` points -> (N, C) host float32."""
    dev = resolve_device(device)
    vals = torch.tensor(np.asarray(values, np.float32), device=dev)
    pts = torch.tensor(np.asarray(points, np.float32), device=dev)
    return torch.cat([grid_sample(vals, pts[i:i + chunk]) for i in range(0, max(1, pts.shape[0]), chunk)]).cpu().numpy()


def upsampled_marching_cubes(
    sdf: np.ndarray, resolution: int, iso: float = 0.0, device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate the trilinear interpolant at `resolution`^3 nodes on
    `device`, then extract (the reference's multi-res MC evaluation grid)."""
    xs = np.linspace(0.0, 1.0, resolution, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    v = sdf if sdf.ndim == 4 else sdf[..., None]
    dense = _sample(v, np.stack([gx, gy, gz], -1).reshape(-1, 3), device)
    return marching_cubes(dense.reshape(resolution, resolution, resolution), iso)


def sample_vertex_attributes(
    verts: np.ndarray, albedo: np.ndarray, roughness: np.ndarray | None = None, device=None
) -> dict:
    """Texture the mesh: trilinear-sample material volumes at vertices on
    `device` (the reference's reflectance/roughness texturing,
    exporter.py:529-546)."""
    out = {"albedo": _sample(albedo, verts, device)}
    if roughness is not None:
        out["roughness"] = _sample(roughness, verts, device)
    return out


def write_obj(path, verts: np.ndarray, faces: np.ndarray, colors: np.ndarray | None = None):
    """OBJ writer (xyzrgb vertex-color extension when colors given)."""
    with open(path, "w") as f:
        for i, v in enumerate(verts):
            if colors is not None:
                c = colors[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")


def write_ply(path, verts: np.ndarray, faces: np.ndarray, colors: np.ndarray | None = None):
    """ASCII PLY writer (the reference's PLY debug dumps)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]} {v[1]} {v[2]}"
            if colors is not None:
                c = np.clip(colors[i] * 255, 0, 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def read_ply_or_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal mesh reader for the chamfer tool."""
    path = str(path)
    verts, faces = [], []
    if path.endswith(".obj"):
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(x) for x in line.split()[1:4]])
                elif line.startswith("f "):
                    idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:4]]
                    faces.append(idx)
    else:  # ascii ply
        with open(path) as f:
            n_v = n_f = 0
            for line in f:
                line = line.strip()
                if line.startswith("element vertex"):
                    n_v = int(line.split()[-1])
                elif line.startswith("element face"):
                    n_f = int(line.split()[-1])
                elif line == "end_header":
                    break
            for _ in range(n_v):
                verts.append([float(x) for x in next(f).split()[:3]])
            for _ in range(n_f):
                parts = next(f).split()
                faces.append([int(x) for x in parts[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
