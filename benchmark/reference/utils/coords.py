"""World <-> render-space transforms (port of nerf_emitter_tpu/utils/coords.py).

World space is [-s, s]^3 (nerfstudio/OpenGL convention); the SDF renderer's
render space is the unit cube [0, 1]^3. `mi2gl_left` / `gl2mi_left` keep the
reference's Mitsuba <-> GL permutation for datasets in Mitsuba's frame.
The matrices are float32 CPU tensors.
"""

from __future__ import annotations

import torch

# Mitsuba points -> GL world (the reference's mi2gl_left)
_MI2GL = ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, -1.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def mi2gl_left() -> torch.Tensor:
    return torch.tensor(_MI2GL, dtype=torch.float32)


def gl2mi_left() -> torch.Tensor:
    return torch.linalg.inv(torch.tensor(_MI2GL, dtype=torch.float64)).float()


def apply_homogeneous(mat4: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """A 4x4 affine applied to (..., 3) points."""
    return points @ mat4[:3, :3].T + mat4[:3, 3]


def apply_rotation(mat4: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Only the linear part of a 4x4 applied to (..., 3) directions."""
    return dirs @ mat4[:3, :3].T


def world_to_unit(points: torch.Tensor, scene_scale: float) -> torch.Tensor:
    """[-s, s]^3 world -> [0, 1]^3 render space (SDF grid domain)."""
    return (points / scene_scale + 1.0) * 0.5


def unit_to_world(points: torch.Tensor, scene_scale: float) -> torch.Tensor:
    """[0, 1]^3 render space -> [-s, s]^3 world."""
    return (points * 2.0 - 1.0) * scene_scale


def world_to_unit_mat(scene_scale: float) -> torch.Tensor:
    """world_to_unit as a 4x4."""
    m = torch.eye(4, dtype=torch.float32)
    m[:3, :3] *= 0.5 / scene_scale
    m[:3, 3] = 0.5
    return m


def unit_to_world_mat(scene_scale: float) -> torch.Tensor:
    """unit_to_world as a 4x4."""
    m = torch.eye(4, dtype=torch.float32)
    m[:3, :3] *= 2.0 * scene_scale
    m[:3, 3] = -scene_scale
    return m
