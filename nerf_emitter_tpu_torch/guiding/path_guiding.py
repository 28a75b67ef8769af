"""Path-guiding strategies (port of nerf_emitter_tpu/guiding/path_guiding.py),
by the registry's names:

- 'vmf' (`VMFGuiding`): extract the NeRF's light point cloud,
  mean-compensate and threshold it, fit a 64-component spherical GMM in
  render space, and load (position, weight, std) into a `VMFMixture`;
  rebuilt every `rebuild_every` takeover steps;
- 'env' (`EnvGuiding`): the ground-truth envmap of the dataset, both the
  sampling proposal and the radiance (the sdf-gt-envmap baseline);
- 'emitter_xml' (`EmitterImageGuiding`): any envmap image swapped in for
  relighting.

The envmap strategies read `.npy` or `.exr` images (utils/exr.py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..renderer.emitters import EnvmapEmitter, VMFMixture
from ..utils import coords, exr, profiler
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
        with profiler.span("guiding.fit"):
            pts, w = compensate_pc(pc["points"], pc["luminance"], self.max_points,
                                   mean_mult=1.0 if self.mis_compensation else 0.0)
            pts_unit = coords.world_to_unit(pts, self.scene_scale)
            means, pis, stds = fit_spherical_gmm(generator, pts_unit, w, self.n_clusters, seed_idx=seed_idx)
            return VMFMixture(positions=means, weights=pis, stds=torch.clamp(stds, min=1e-3))

    def should_rebuild(self, mi_step: int) -> bool:
        return mi_step % self.rebuild_every == 0


def _envmap_from_file(path: Path, device) -> EnvmapEmitter:
    img = np.load(path) if path.suffix == ".npy" else exr.read_exr(path)
    return EnvmapEmitter.create(torch.as_tensor(np.asarray(img[..., :3], np.float32), device=device))


@dataclasses.dataclass
class EnvGuiding:
    """The ground-truth envmap as the proposal (the sdf-gt-envmap
    baseline): `env_path`, or env.exr in the dataset's directory."""

    env_path: Optional[Path] = None

    def build_envmap(self, data_dir: Path, device=None) -> EnvmapEmitter:
        path = Path(self.env_path) if self.env_path else Path(data_dir) / "env.exr"
        return _envmap_from_file(path, device)


@dataclasses.dataclass
class EmitterImageGuiding:
    """An arbitrary relighting emitter: any envmap image, swapped in at eval
    time."""

    emitter_path: Path = Path("env.exr")

    def build_envmap(self, device=None) -> EnvmapEmitter:
        return _envmap_from_file(Path(self.emitter_path), device)


GUIDING_REGISTRY = {
    "vmf": VMFGuiding,
    "env": EnvGuiding,
    "emitter_xml": EmitterImageGuiding,  # the reference's name, kept for the CLI
}
