"""SdfScene (port of nerf_emitter_tpu/renderer/scene.py): the voxel grids
and the emitter state of the SDF renderer, in the unit cube [0, 1]^3
(render space). "Traversing" the scene is attribute access; the optimiser
updates the sdf, albedo and roughness tensors."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .emitters import EnvmapEmitter, VMFMixture
from .grid3d import sphere_sdf_grid

DIFFUSE = 0
PRINCIPLED = 1


@dataclasses.dataclass
class SdfScene:
    """sdf (R, R, R, 1), albedo (Ra, Ra, Ra, 3), roughness (Rr, Rr, Rr, 1).
    `envmap` is an environment emitter (the GT-envmap baseline and
    relighting); when the NeRF is the emitter, radiance comes from the
    integrator's emitter function instead, and `guiding` proposes its
    directions."""

    sdf: torch.Tensor
    albedo: torch.Tensor
    roughness: torch.Tensor
    envmap: Optional[EnvmapEmitter] = None
    guiding: Optional[VMFMixture] = None
    bsdf_type: int = DIFFUSE
    hide_emitters: bool = False

    def replace(self, **kw) -> "SdfScene":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def create(
        sdf_res: int = 64,
        tex_res: int = 32,
        bsdf_type: int = DIFFUSE,
        envmap: Optional[EnvmapEmitter] = None,
        init_albedo: float = 0.5,
        init_roughness: float = 0.5,
        init_radius: float = 0.3,
        device=None,
    ) -> "SdfScene":
        return SdfScene(
            sdf=sphere_sdf_grid(sdf_res, radius=init_radius, device=device),
            albedo=torch.full((tex_res, tex_res, tex_res, 3), init_albedo, device=device),
            roughness=torch.full((tex_res, tex_res, tex_res, 1), init_roughness, device=device),
            envmap=envmap,
            bsdf_type=bsdf_type,
        )
