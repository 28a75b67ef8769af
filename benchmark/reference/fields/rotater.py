"""Rotater: turntable rotation of the scene and light relative to the object
(port of nerf_emitter_tpu/fields/rotater.py).

Captures on a turntable under fixed lighting tag each image with a
rotation id; the NeRF sees the world rotated per id while the object stays
put. Rotation is a pure function of the rays (or of the sample positions
inside a bounding sphere), batched over a per-ray rotation id.

Two sources of rotations: axis-angle about a centre (synthetic
turntables; angle 2 pi id / n about +y by default), and calibrated per-id
4x4 transforms (real captures). An optional learnable per-rotation SO3xR3
correction (`deltas`, rotation id 0 frozen) is the reference's
`rotation_optimizer`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


def _axis_angle_matrix(axis: torch.Tensor, angle: float) -> torch.Tensor:
    """Rodrigues: (3,) unit axis, angle -> (3, 3)."""
    x, y, z = axis[0], axis[1], axis[2]
    a = torch.as_tensor(angle, dtype=torch.float32).to(axis)
    c, s = torch.cos(a), torch.sin(a)
    cc = 1.0 - c
    return torch.stack([
        torch.stack([c + x * x * cc, x * y * cc - z * s, x * z * cc + y * s]),
        torch.stack([y * x * cc + z * s, c + y * y * cc, y * z * cc - x * s]),
        torch.stack([z * x * cc - y * s, z * y * cc + x * s, c + z * z * cc]),
    ])


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """so3 exponential: (..., 3) -> (..., 3, 3) rotations.

    Taylor-safe sinc terms keep the gradient at w = 0 finite (pose deltas
    start at 0); the exact branch is evaluated at a safe theta so the
    unselected branch never makes inf or NaN."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    zero = torch.zeros_like(w[..., 0])
    wx = torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * wx + b[..., None, None] * (wx @ wx)


def _rigid(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation and (3,) translation -> (4, 4)."""
    m = torch.eye(4, dtype=r.dtype, device=r.device)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


@dataclasses.dataclass
class Rotater:
    """Per-rotation-id rigid transforms. transforms (n_rot, 4, 4) map the
    object frame to the rotated world frame of each id; center (3,) is the
    rotation centre; deltas, optional learnable (n_rot, 6) (so3,
    translation) corrections."""

    transforms: torch.Tensor
    center: torch.Tensor
    deltas: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "Rotater":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def _about_axis(angles, center: torch.Tensor, axis: Optional[torch.Tensor]) -> "Rotater":
        center = torch.as_tensor(center, dtype=torch.float32)
        if axis is None:
            axis = torch.tensor([0.0, 1.0, 0.0], device=center.device)
        mats = []
        for a in angles:
            r = _axis_angle_matrix(axis, a)
            mats.append(_rigid(r, center - r @ center))
        return Rotater(transforms=torch.stack(mats), center=center)

    @staticmethod
    def from_axis_angle(n_rotations: int, center, axis=None, full_turn: float = 2.0 * math.pi) -> "Rotater":
        """Evenly spaced turntable rotations about `axis` through `center`."""
        return Rotater._about_axis([full_turn * i / n_rotations for i in range(n_rotations)],
                                   center, axis)

    @staticmethod
    def from_angles(angles_deg, center, axis=None) -> "Rotater":
        """Per-id rotations from raw `rotation` tag values in degrees about
        `axis` (+y by default) through `center`."""
        return Rotater._about_axis([torch.deg2rad(torch.tensor(float(a))) for a in angles_deg],
                                   center, axis)

    @staticmethod
    def from_matrices(transform_matrices, center) -> "Rotater":
        """Calibrated transforms from the dataparser (real captures)."""
        return Rotater(transforms=torch.as_tensor(transform_matrices, dtype=torch.float32),
                       center=torch.as_tensor(center, dtype=torch.float32))

    def matrix(self, rot_id: torch.Tensor) -> torch.Tensor:
        """(...,) int ids -> (..., 4, 4), the learnable correction applied
        on the left (id 0 frozen)."""
        rot_id = torch.as_tensor(rot_id, device=self.transforms.device).long()
        m = self.transforms[rot_id]
        if self.deltas is not None:
            d = self.deltas[rot_id]
            d = torch.where((rot_id == 0)[..., None], torch.zeros_like(d), d)
            corr = torch.zeros_like(m)
            corr[..., :3, :3] = exp_so3(d[..., :3])
            corr[..., :3, 3] = d[..., 3:]
            corr[..., 3, 3] = 1.0
            m = torch.einsum("...ij,...jk->...ik", corr, m)
        return m

    def apply_points(self, rot_id, points: torch.Tensor) -> torch.Tensor:
        """Rotate (..., 3) points by their per-element rotation id (...,)."""
        m = self.matrix(rot_id)
        return torch.einsum("...ij,...j->...i", m[..., :3, :3], points) + m[..., :3, 3]

    def apply_dirs(self, rot_id, dirs: torch.Tensor) -> torch.Tensor:
        m = self.matrix(rot_id)
        return torch.einsum("...ij,...j->...i", m[..., :3, :3], dirs)

    def apply_c2w(self, rot_id, c2w: torch.Tensor) -> torch.Tensor:
        """Rotate camera-to-world matrices (..., 3, 4) into the rotated world."""
        m = self.matrix(rot_id)
        r = torch.einsum("...ij,...jk->...ik", m[..., :3, :3], c2w[..., :3, :3])
        t = torch.einsum("...ij,...j->...i", m[..., :3, :3], c2w[..., :3, 3]) + m[..., :3, 3]
        return torch.cat([r, t[..., :, None]], dim=-1)

    def apply_positions_within(self, rot_id, positions: torch.Tensor, dirs: Optional[torch.Tensor],
                               bounding_radius: float):
        """World -> canonical mapping of per-ray sample positions (n, S, 3)
        inside the bounding sphere (the reference's RayBundle.rotater hook);
        outside it the static environment stays world-framed. rot_id (n,)."""
        m = self.matrix(rot_id)
        r_t = m[..., :3, :3].transpose(-1, -2)
        p = torch.einsum("nij,nsj->nsi", r_t, positions - m[:, None, :3, 3])
        inside = torch.linalg.norm(positions - self.center, dim=-1, keepdim=True) < bounding_radius
        p_out = torch.where(inside, p, positions)
        if dirs is None:
            return p_out, None
        d = torch.einsum("nij,nsj->nsi", r_t, dirs)
        return p_out, torch.where(inside, d, dirs)

    def apply_c2w_inverse(self, rot_id, c2w: torch.Tensor) -> torch.Tensor:
        """World -> canonical camera pose: R_i^{-1} c2w."""
        m = self.matrix(rot_id)
        r_t = m[..., :3, :3].transpose(-1, -2)
        r = torch.einsum("...ij,...jk->...ik", r_t, c2w[..., :3, :3])
        t = torch.einsum("...ij,...j->...i", r_t, c2w[..., :3, 3] - m[..., :3, 3])
        return torch.cat([r, t[..., :, None]], dim=-1)

    def apply_rays_within(self, rot_id, origins: torch.Tensor, directions: torch.Tensor,
                          bounding_radius: Optional[float] = None):
        """Rotate rays by the inverse transform; with a radius, rays whose
        origin lies outside the bounding sphere stay untouched."""
        m = self.matrix(rot_id)
        r_t = m[..., :3, :3].transpose(-1, -2)
        o = torch.einsum("...ij,...j->...i", r_t, origins - m[..., :3, 3])
        d = torch.einsum("...ij,...j->...i", r_t, directions)
        if bounding_radius is None:
            return o, d
        inside = torch.linalg.norm(origins - self.center, dim=-1, keepdim=True) < bounding_radius
        return torch.where(inside, o, origins), torch.where(inside, d, directions)


def unique_rotation_ids(rotation_tags) -> tuple[dict, list]:
    """Map raw per-image rotation tags to dense ids."""
    uniq = sorted(set(int(r) for r in rotation_tags))
    table = {r: i for i, r in enumerate(uniq)}
    return table, [table[int(r)] for r in rotation_tags]
