"""NerfactoModel (HDR) for the `freq` field (port of
nerf_emitter_tpu/models/nerfacto.py), eval forward only.

`forward(rays, hdr_radiance_only=True)` is the emitter query's plain path;
without it the eval outputs are rgb, accumulation and depth. Training
outputs, `point_lights` and the rotater hook are later slices.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

import torch
from torch import nn

from ..cameras.rays import RayBundle
from ..fields.nerfacto_field import HashMLPDensityField, NerfactoField
from ..ops import rendering
from ..ops.samplers import proposal_sample
from ..utils.device import resolve_device


class NerfactoModel(nn.Module):
    """HDR nerfacto: two proposal density fields (F=4 and F=6, one hidden
    layer of 128) and the radiance field (F=10, 6x256 base, 3x64 head)."""

    def __init__(
        self,
        aabb,
        *,
        num_nerf_samples: int = 48,
        num_proposal_samples: tuple = (256, 96),
        hdr: bool = True,
        rgb_bias: float = 0.0,
        background_color: str = "last_sample",
        use_fake_contraction: bool = True,
        num_cameras: int = 128,
        appearance_embedding_dim: int = 32,
        single_jitter: bool = True,
        depth_method: str = "median",
        implementation: str = "hash",
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.aabb = tuple(tuple(float(x) for x in row) for row in aabb)
        self.num_nerf_samples = int(num_nerf_samples)
        self.num_proposal_samples = tuple(int(s) for s in num_proposal_samples)
        self.hdr = hdr
        self.rgb_bias = rgb_bias
        self.background_color = background_color
        self.use_fake_contraction = use_fake_contraction
        self.appearance_embedding_dim = appearance_embedding_dim
        self.single_jitter = single_jitter
        self.depth_method = depth_method
        self.implementation = implementation
        self.field = NerfactoField(
            aabb, hdr=hdr, rgb_bias=rgb_bias, num_cameras=num_cameras,
            appearance_embedding_dim=appearance_embedding_dim,
            use_fake_contraction=use_fake_contraction,
            implementation=implementation, device=device,
        )
        self.proposal_0 = HashMLPDensityField(
            aabb, use_fake_contraction=use_fake_contraction,
            implementation=implementation, freq_num_frequencies=4, device=device,
        )
        self.proposal_1 = HashMLPDensityField(
            aabb, use_fake_contraction=use_fake_contraction,
            implementation=implementation, freq_num_frequencies=6, device=device,
        )

    @property
    def proposal_networks(self) -> list[HashMLPDensityField]:
        return [self.proposal_0, self.proposal_1]

    @property
    def device(self) -> torch.device:
        return self.field.aabb.device

    def with_samples(self, num_proposal_samples, num_nerf_samples) -> "NerfactoModel":
        """A view of this model with another per-ray sample schedule; the
        parameters are shared (sample counts shape sampling, not weights)."""
        view = copy.copy(self)
        view.num_proposal_samples = tuple(int(s) for s in num_proposal_samples)
        view.num_nerf_samples = int(num_nerf_samples)
        return view

    def forward(
        self,
        ray_bundle: RayBundle,
        *,
        train: bool = False,
        disable_aabb=None,
        disable_aabb_on: bool = False,
        use_average_appearance: bool = False,
        hdr_radiance_only: bool = False,
    ) -> dict[str, Any]:
        """rays (n, ...) -> {'rgb'} or {'rgb', 'accumulation', 'depth'}.
        Deterministic (bin-centre) sampling; differentiable end to end."""
        if train:
            raise NotImplementedError(
                "training outputs are not ported yet (ROADMAP.md, Queue 1 item 3)"
            )

        def make_density_fn(net):
            def fn(pos, cam: Optional[torch.Tensor]):
                return net(pos, disable_aabb=disable_aabb, disable_aabb_on=disable_aabb_on)
            return fn

        ray_samples, _, _ = proposal_sample(
            ray_bundle,
            [make_density_fn(net) for net in self.proposal_networks],
            list(self.num_proposal_samples),
            self.num_nerf_samples,
            single_jitter=self.single_jitter,
        )
        positions = ray_samples.frustums.get_positions()
        dirs = ray_bundle.directions[..., None, :].expand(positions.shape)
        density, geo = self.field.get_density(
            positions, disable_aabb=disable_aabb, disable_aabb_on=disable_aabb_on
        )
        rgb_samples = self.field.get_rgb(
            geo, dirs, ray_samples.camera_indices,
            use_average_appearance=use_average_appearance,
        )
        weights = ray_samples.get_weights(density)
        rgb = rendering.composite_rgb(
            rgb_samples, weights, background_color=self.background_color,
            hdr=self.hdr, is_training=False,
        )
        if hdr_radiance_only:
            return {"rgb": rgb}
        return {
            "rgb": rgb,
            "accumulation": rendering.composite_accumulation(weights),
            "depth": rendering.composite_depth(
                weights, ray_samples.frustums.starts, ray_samples.frustums.ends,
                method=self.depth_method,
            ),
        }
