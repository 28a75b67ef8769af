"""Position and direction encodings (port of
nerf_emitter_tpu/fields/encodings.py): the multi-resolution hash grid
(`hash_encode`), `sh_encode` and `nerf_encode`.

These are the model path's encodings: direct sin/cos per octave. The
kernels use the double-angle recurrence instead (ops/fused_field.py). The
fields encode with the hash grid through ops/hash_grid.py, whose kernel
(csrc/hash_grid.cu) serves CUDA tensors. `hash_encode` here is its plain
twin and the tests' reference, plain PyTorch as the reference's is plain
XLA: one gather per (level, corner) on the flat (T, F) table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# large primes for spatial hashing (Mueller et al., instant-ngp)
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
_CORNER_OFFSETS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def hash_level_resolutions(num_levels: int, min_res: int, max_res: int) -> list[int]:
    """Per-level grid resolutions with geometric growth (instant-ngp eq. 2)."""
    if num_levels == 1:
        return [min_res]
    growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1))
    return [int(np.floor(min_res * growth**l)) for l in range(num_levels)]


class HashGridSpec:
    """Static geometry of a multi-res hash grid. Levels whose (res+1)^3
    corner grid fits the table budget are stored densely (collision-free);
    finer levels hash. All levels share one flat (total_size, F) table."""

    def __init__(self, num_levels: int = 16, features_per_level: int = 2,
                 log2_hashmap_size: int = 19, min_res: int = 16, max_res: int = 2048):
        self.num_levels = num_levels
        self.features_per_level = features_per_level
        self.table_size = 2**log2_hashmap_size
        self.resolutions = hash_level_resolutions(num_levels, min_res, max_res)
        self.level_sizes = [min((r + 1) ** 3, self.table_size) for r in self.resolutions]
        self.offsets = np.concatenate([[0], np.cumsum(self.level_sizes)]).tolist()
        self.total_size = self.offsets[-1]
        self.out_dim = num_levels * features_per_level
        # per level: resolution, rows, first row, dense (the kernel's rows)
        self.level_rows = [(r, n, o, int((r + 1) ** 3 <= n))
                           for r, n, o in zip(self.resolutions, self.level_sizes, self.offsets)]
        self._level_tables: dict = {}

    def level_table(self, device) -> torch.Tensor:
        """`level_rows` as an (L, 4) int32 tensor on `device`, built once
        per device."""
        device = torch.device(device)
        t = self._level_tables.get(device)
        if t is None:
            t = self._level_tables[device] = torch.tensor(self.level_rows, dtype=torch.int32, device=device)
        return t

    def init_table(self, scale: float = 1e-4, device=None) -> torch.Tensor:
        t = torch.empty(self.total_size, self.features_per_level, device=device)
        return t.uniform_(-scale, scale)


def _corner_index(bx, by, bz, cx: int, cy: int, cz: int, res: int, level_size: int,
                  offset: int) -> torch.Tensor:
    """Flat table index of one corner of one level; b* are int64 (N,).

    The reference computes in uint32: each product by a prime wraps mod
    2^32. Here the products are int64 (corner coords <= 2^11, primes
    < 2^32: under 2^43, exact) masked back to 32 bits, so the XOR and the
    remainder see the same words."""
    ix, iy, iz = bx + cx, by + cy, bz + cz
    if (res + 1) ** 3 <= level_size:
        idx = ix + (res + 1) * (iy + (res + 1) * iz)
    else:
        h = (ix * _PRIMES[0]) & _U32
        h = h ^ ((iy * _PRIMES[1]) & _U32)
        h = h ^ ((iz * _PRIMES[2]) & _U32)
        idx = h % level_size
    return idx + offset


def hash_encode(table: torch.Tensor, positions: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """positions in [0,1]^3, shape (N, 3) -> features (N, L*F) by trilinear
    interpolation of each level's 8 corners.

    A dense level's far corner at pos == 1 has weight 0 and index past the
    level (past the table at the last level); XLA's gather clamps such an
    index, and so does this one, so a sample on the box face never reads
    outside the table."""
    pos = positions.clamp(0.0, 1.0)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    last = spec.total_size - 1
    outs = []
    for l in range(spec.num_levels):
        s = float(spec.resolutions[l])
        sx, sy, sz = x * s, y * s, z * s
        bx, by, bz = torch.floor(sx), torch.floor(sy), torch.floor(sz)
        fx, fy, fz = sx - bx, sy - by, sz - bz
        bxi, byi, bzi = bx.long(), by.long(), bz.long()
        acc = None
        for cx, cy, cz in _CORNER_OFFSETS:
            idx = _corner_index(bxi, byi, bzi, cx, cy, cz, spec.resolutions[l],
                                spec.level_sizes[l], spec.offsets[l]).clamp(max=last)
            w = (fx if cx else 1.0 - fx) * (fy if cy else 1.0 - fy) * (fz if cz else 1.0 - fz)
            contrib = table[idx] * w[:, None]
            acc = contrib if acc is None else acc + contrib
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def sh_components(x, y, z, degree: int = 4) -> list:
    """Real SH basis components up to `degree` bands (<= 4 -> 16), each
    shaped like x; same coefficients and order as the reference."""
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        comps += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree > 2:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if degree > 3:
        comps += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    if degree > 4:
        raise NotImplementedError("SH degree > 4")
    return comps


def sh_encode(directions: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Unit directions (..., 3) -> (..., degree**2)."""
    comps = sh_components(directions[..., 0], directions[..., 1], directions[..., 2], degree)
    return torch.stack(comps, dim=-1)


def sh_dim(degree: int) -> int:
    return degree**2


def nerf_encode_dim(in_dim: int, num_frequencies: int, include_input: bool = True) -> int:
    """nerf_encode's output width."""
    return in_dim * (2 * num_frequencies + (1 if include_input else 0))


def nerf_encode(
    x: torch.Tensor,
    num_frequencies: int = 10,
    min_freq_exp: float = 0.0,
    max_freq_exp: float = 9.0,
    include_input: bool = True,
) -> torch.Tensor:
    """(..., D) -> (..., D*(2F+1)): [x, sin (d-major, f-minor), cos]."""
    freqs = 2.0 ** torch.linspace(min_freq_exp, max_freq_exp, num_frequencies, device=x.device)
    scaled = (x[..., :, None] * freqs).reshape(*x.shape[:-1], -1)
    parts = [torch.sin(2.0 * math.pi * scaled), torch.cos(2.0 * math.pi * scaled)]
    if include_input:
        parts = [x] + parts
    return torch.cat(parts, dim=-1)
