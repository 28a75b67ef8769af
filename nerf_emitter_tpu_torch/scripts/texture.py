"""Texture an EXISTING mesh from an optimized run's material volumes.

Port of nerf_emitter_tpu/scripts/texture.py: the atlas and the bake are
its numpy, copied; the volumes are sampled by the port's trilinear
`renderer/grid3d.grid_sample` on `--device` (CUDA by default), and the
textures are written by `utils/video.write_png` (no PIL).

Re-design of the reference's `scripts/texture.py` (TextureMesh, :32-75,
which UV-unwraps a mesh and bakes NeRF colors via
exporter/texture_utils.py). Here the color source is the inverse-rendering
result itself — the albedo/roughness voxel grids — and the unwrap is the
reference's "custom" per-face grid atlas (no xatlas dependency): each
triangle owns half of a padded square cell in a regular UV grid, texels
are barycentrically mapped to surface points and trilinearly sampled from
the volumes.

  python -m nerf_emitter_tpu_torch.scripts.texture \
      --input-mesh exports/lego/mesh.obj \
      --albedo-volume exports/lego/albedo.npy \
      [--roughness-volume ...] [--px-per-uv-triangle 4] \
      --output-dir exports/lego_textured [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..renderer.grid3d import grid_sample
from ..utils.device import resolve_device
from ..utils.video import write_png


def read_obj(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader: v/f lines (f may be v, v/vt, v/vt/vn)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:4]]
                faces.append(idx)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def grid_atlas_uvs(n_faces: int, px_per_tri: int, tex_size: int | None = None):
    """Per-face UV coordinates of the custom grid atlas.

    Each square cell of side `p = px_per_tri + 6` texels holds two
    triangles (lower-left and upper-right of the cell anti-diagonal).
    Triangle hypotenuses sit 2 texels clear of the diagonal split line so
    each half's gutter never bleeds into the other (the two faces of a
    cell are generally NOT mesh-adjacent). Returns
    (uvs (n_faces, 3, 2) in [0,1], tex_size).
    """
    p = px_per_tri + 6
    n_cells = (n_faces + 1) // 2
    cols = int(np.ceil(np.sqrt(n_cells)))
    rows = int(np.ceil(n_cells / cols))
    if tex_size is None:
        tex_size = int(2 ** np.ceil(np.log2(max(cols, rows) * p)))
    f = np.arange(n_faces)
    cell = f // 2
    upper = (f % 2).astype(bool)
    cx = (cell % cols) * p
    cy = (cell // cols) * p
    m = 1.0  # edge gutter margin (texels)
    w = p - 5.0  # hypotenuse at lx+ly = p-3: 2 texels off the split lx+ly=p-1
    # lower triangle: (m,m), (m+w,m), (m,m+w); upper: mirrored into the
    # opposite corner
    lo = np.stack(
        [
            np.stack([cx + m, cy + m], -1),
            np.stack([cx + m + w, cy + m], -1),
            np.stack([cx + m, cy + m + w], -1),
        ],
        axis=1,
    ).astype(np.float64)
    q = p - 2.0  # opposite corner offset
    hi = np.stack(
        [
            np.stack([cx + q, cy + q], -1),
            np.stack([cx + q - w, cy + q], -1),
            np.stack([cx + q, cy + q - w], -1),
        ],
        axis=1,
    ).astype(np.float64)
    uv_tex = np.where(upper[:, None, None], hi, lo)  # texel coords
    return uv_tex / tex_size, tex_size


def bake_texture(
    verts: np.ndarray,
    faces: np.ndarray,
    uvs: np.ndarray,
    tex_size: int,
    sample_fn,
    px_per_tri: int,
) -> np.ndarray:
    """Fill the atlas: for every texel of a face's OWN cell half,
    barycentric-map to a surface point and sample. Vectorized over
    (faces, cell texels)."""
    p = px_per_tri + 6
    # texel lattice of one cell
    ty, tx = np.mgrid[0:p, 0:p]
    tx = tx.reshape(-1)
    ty = ty.reshape(-1)
    n_faces = len(faces)
    tex = np.zeros((tex_size, tex_size, 3), np.float32)

    uv_tex = uvs * tex_size  # (F, 3, 2) texel coords of triangle corners
    # cell origin per face (lower tri min corner is (m,m); upper's cell
    # origin recovered from its max corner at (q,q))
    upper = np.arange(n_faces) % 2 == 1
    cx = np.where(upper, np.max(uv_tex[..., 0], 1) - (p - 2.0), np.min(uv_tex[..., 0], 1) - 1.0)
    cy = np.where(upper, np.max(uv_tex[..., 1], 1) - (p - 2.0), np.min(uv_tex[..., 1], 1) - 1.0)
    gx = (np.round(cx)[:, None] + tx[None, :]).astype(np.int64)  # (F, p*p)
    gy = (np.round(cy)[:, None] + ty[None, :]).astype(np.int64)
    px = gx + 0.5
    py = gy + 0.5
    # ownership: which half of the cell the texel belongs to
    diag = tx + ty  # (p*p,)
    own = np.where(upper[:, None], diag[None, :] >= p - 1, diag[None, :] <= p - 1)

    a, b, c = uv_tex[:, 0], uv_tex[:, 1], uv_tex[:, 2]  # (F, 2)
    v0 = b - a
    v1 = c - a
    det = v0[:, 0] * v1[:, 1] - v0[:, 1] * v1[:, 0]
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    qx = px - a[:, None, 0]
    qy = py - a[:, None, 1]
    wb = (qx * v1[:, None, 1] - qy * v1[:, None, 0]) / det[:, None]
    wc = (qy * v0[:, None, 0] - qx * v0[:, None, 1]) / det[:, None]
    # clamp into the triangle (gutter texels snap to the nearest edge point)
    wb = np.clip(wb, 0.0, 1.0)
    wc = np.clip(wc, 0.0, 1.0)
    s = wb + wc
    scale = np.where(s > 1.0, 1.0 / np.maximum(s, 1e-12), 1.0)
    wb *= scale
    wc *= scale
    wa = 1.0 - wb - wc

    tri = verts[faces]  # (F, 3, 3)
    pts = (
        wa[..., None] * tri[:, None, 0]
        + wb[..., None] * tri[:, None, 1]
        + wc[..., None] * tri[:, None, 2]
    )  # (F, p*p, 3)
    colors = sample_fn(pts.reshape(-1, 3)).reshape(n_faces, -1, 3)

    inb = own & (gx >= 0) & (gx < tex_size) & (gy >= 0) & (gy < tex_size)
    tex[gy[inb], gx[inb]] = colors[inb]
    return tex


def write_textured_obj(out_dir: Path, name, verts, faces, uvs):
    """OBJ + MTL referencing the baked PNG textures."""
    with open(out_dir / f"{name}.mtl", "w") as f:
        f.write(f"newmtl material0\nKa 1 1 1\nKd 1 1 1\nmap_Kd {name}_albedo.png\n")
    with open(out_dir / f"{name}.obj", "w") as f:
        f.write(f"mtllib {name}.mtl\nusemtl material0\n")
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face_uv in uvs:
            for u, v in face_uv:
                f.write(f"vt {u} {v}\n")
        for i, tri in enumerate(faces):
            t = 3 * i
            f.write(
                f"f {tri[0]+1}/{t+1} {tri[1]+1}/{t+2} {tri[2]+1}/{t+3}\n"
            )


def volume_sampler(volume: np.ndarray, device, channels: int = 3):
    """points (P, 3) in [0, 1]^3 -> (P, 3) float32 trilinear samples of the
    (R, R, R, C) volume on `device`; a one-channel volume is repeated to
    three (the roughness texture is grey)."""
    values = torch.as_tensor(np.asarray(volume, np.float32), device=device)

    def sample(pts: np.ndarray) -> np.ndarray:
        p = torch.as_tensor(np.asarray(pts, np.float32), device=device)
        out = grid_sample(values, p)[..., :channels].cpu().numpy()
        return np.repeat(out, 3, axis=-1) if channels == 1 else out

    return sample


def main(argv=None):
    ap = argparse.ArgumentParser(prog="texture")
    ap.add_argument("--input-mesh", type=Path, required=True)
    ap.add_argument("--albedo-volume", type=Path, required=True,
                    help=".npy material volume from the exporter")
    ap.add_argument("--roughness-volume", type=Path, default=None)
    ap.add_argument("--px-per-uv-triangle", type=int, default=4)
    ap.add_argument("--output-dir", type=Path, default=Path("exports/textured"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    args.output_dir.mkdir(parents=True, exist_ok=True)
    verts, faces = read_obj(args.input_mesh)
    print(f"mesh: {len(verts)} verts, {len(faces)} faces")
    uvs, tex_size = grid_atlas_uvs(len(faces), args.px_per_uv_triangle)
    print(f"atlas: {tex_size}x{tex_size}")

    tex = bake_texture(verts, faces, uvs, tex_size, volume_sampler(np.load(args.albedo_volume), device),
                       args.px_per_uv_triangle)
    write_png(args.output_dir / "mesh_albedo.png", tex)
    if args.roughness_volume is not None:
        rtex = bake_texture(verts, faces, uvs, tex_size, volume_sampler(np.load(args.roughness_volume), device, 1),
                            args.px_per_uv_triangle)
        write_png(args.output_dir / "mesh_roughness.png", rtex)
    write_textured_obj(args.output_dir, "mesh", verts, faces, uvs)
    print(f"wrote textured mesh to {args.output_dir}")


if __name__ == "__main__":
    main()
