"""The vMF path-guiding strategy (a frozen copy of the port's
guiding/path_guiding.py, itself a port of nerf_emitter_tpu/guiding/path_guiding.py):
extract the NeRF's light point cloud, mean-compensate and threshold it,
fit a 64-component spherical GMM in render space, and load (position,
weight, std) into a `VMFMixture`. Departure: the envmap strategies are
left out (no benchmark cell uses them)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..renderer.emitters import VMFMixture
from ..utils import coords
from .gmm import fit_spherical_gmm
from .light_pc import compensate_pc, extract_light_point_cloud

N_CLUSTER = 64


@dataclasses.dataclass
class VMFGuiding:
    """NeRF-emitter importance sampling via a vMF mixture.

    `mis_compensation` fits the luminance excess over the mean (the broad
    mean is left to BSDF sampling, the other strategy of the MIS pair);
    off, the raw luminance."""

    n_clusters: int = N_CLUSTER
    max_points: int = 32768
    downscale: int = 4
    use_spherical_rig: bool = False
    rebuild_every: int = 10
    scene_scale: float = 1.0
    mis_compensation: bool = True

    def build(self, generator: Optional[torch.Generator], model, cameras, object_aabb=None,
              *, seed_idx: Optional[torch.Tensor] = None) -> VMFMixture:
        """The mixture from the model's current field (its own parameters,
        the reference's `params`). `generator` draws the GMM's seeds, or
        `seed_idx` gives them."""
        pc = extract_light_point_cloud(model, cameras, object_aabb=object_aabb,
                                       downscale=self.downscale,
                                       use_spherical_rig=self.use_spherical_rig)
        pts, w = compensate_pc(pc["points"], pc["luminance"], self.max_points,
                               mean_mult=1.0 if self.mis_compensation else 0.0)
        pts_unit = coords.world_to_unit(pts, self.scene_scale)
        means, pis, stds = fit_spherical_gmm(generator, pts_unit, w, self.n_clusters, seed_idx=seed_idx)
        return VMFMixture(positions=means, weights=pis, stds=torch.clamp(stds, min=1e-3))

    def should_rebuild(self, mi_step: int) -> bool:
        return mi_step % self.rebuild_every == 0
