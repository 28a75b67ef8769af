"""NerfactoModel (HDR) with the `hash` or `freq` field (port of
nerf_emitter_tpu/models/nerfacto.py): the eval and training forward, the
turntable and pose-delta hooks, and `point_lights`.

`forward(rays, hdr_radiance_only=True)` is the emitter query's plain path;
without it the eval outputs are rgb, accumulation and depth, and with
`train=True` also each level's weights and spacing bins and the final ray
samples, which the interlevel and distortion losses read.
"""

from __future__ import annotations

import copy
from typing import Any, Optional

import torch
from torch import nn

from ..cameras.rays import RayBundle
from ..fields.nerfacto_field import HashMLPDensityField, NerfactoField
from ..fields.rotater import exp_so3
from ..ops import rendering
from ..ops.samplers import proposal_sample, samples_at
from ..utils.device import resolve_device
from ..utils.math import luminance


class NerfactoModel(nn.Module):
    """HDR nerfacto: two proposal density fields and the radiance field.
    `freq`: proposals F=4 and F=6 with one hidden layer of 128, the field
    F=10 with a 6x256 base; `hash`: proposal grids up to 64 and 256 (2^17
    tables), the field's grid up to `max_res` (2^log2_hashmap_size tables)
    with a 2x64 base. Both: a 3x64 head.

    `optimize_camera_poses` adds `camera_opt_deltas` (num_cameras, 6), a
    per-camera SO3xR3 correction of the rays; `optimize_rotations` with
    `num_rotations` adds `rotation_opt_deltas` (num_rotations, 6), the
    turntable's per-rotation correction. Both start at zero."""

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
        log2_hashmap_size: int = 19,
        max_res: int = 2048,
        optimize_camera_poses: bool = False,
        optimize_rotations: bool = False,
        num_rotations: int = 0,
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
        self.num_cameras = num_cameras
        self.optimize_camera_poses = optimize_camera_poses
        self.optimize_rotations = optimize_rotations
        self.num_rotations = num_rotations
        if optimize_camera_poses:
            self.camera_opt_deltas = nn.Parameter(torch.zeros(num_cameras, 6, device=device))
        if optimize_rotations and num_rotations > 0:
            self.rotation_opt_deltas = nn.Parameter(torch.zeros(num_rotations, 6, device=device))
        self.field = NerfactoField(
            aabb, hdr=hdr, rgb_bias=rgb_bias, num_cameras=num_cameras,
            appearance_embedding_dim=appearance_embedding_dim,
            log2_hashmap_size=log2_hashmap_size, max_res=max_res,
            use_fake_contraction=use_fake_contraction,
            implementation=implementation, device=device,
        )
        self.proposal_0 = HashMLPDensityField(
            aabb, max_res=64, log2_hashmap_size=17, use_fake_contraction=use_fake_contraction,
            implementation=implementation, freq_num_frequencies=4, device=device,
        )
        self.proposal_1 = HashMLPDensityField(
            aabb, max_res=256, log2_hashmap_size=17, use_fake_contraction=use_fake_contraction,
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
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        proposal_anneal: float = 1.0,
        disable_aabb=None,
        disable_aabb_on: bool = False,
        use_average_appearance: bool = False,
        hdr_radiance_only: bool = False,
        rotater=None,
        camera_rot_ids: Optional[torch.Tensor] = None,
        rotation_radius: float = 0.6,
        spacing_bins: Optional[torch.Tensor] = None,
    ) -> dict[str, Any]:
        """rays (n, ...) -> {'rgb', 'spacing_bins'} (hdr_radiance_only) or
        {'rgb', 'accumulation', 'depth'}; differentiable end to end.

        'spacing_bins' are the final samples' spacing edges (n, S + 1). Given
        back as `spacing_bins`, they replace the proposal stage: the same
        rays then give the same samples and answer, and the same gradients
        by the rays, since the proposal resample stops the gradient at its
        weights (the edges are constants; only near, far and the ray place
        the samples).

        train=True adds 'weights_list' (each proposal level's weights, then
        the field's), 'spacing_bins_list' (each level's spacing edges
        (n, S_i + 1)) and 'ray_samples' (the field's samples). With a
        `generator` (the reference's key) the training forward samples
        stratified bins and a random background where the background colour
        is 'random'; without one, and always when train=False, the bins are
        the deterministic bin centres. proposal_anneal is the exponent of
        the proposal weights that steer the resampling.

        rotater + camera_rot_ids (num_cameras,) enable the turntable: sample
        positions inside `rotation_radius` of the rotater's centre are
        inverse-rotated into the canonical object frame by the rotation id
        of the ray's camera."""
        generator = generator if train else None
        if self.optimize_camera_poses and ray_bundle.camera_indices is not None:
            d6 = self.camera_opt_deltas[ray_bundle.camera_indices[..., 0]]
            rot = exp_so3(d6[..., :3])
            ray_bundle = ray_bundle.replace(
                origins=torch.einsum("nij,nj->ni", rot, ray_bundle.origins) + d6[..., 3:],
                directions=torch.einsum("nij,nj->ni", rot, ray_bundle.directions),
            )
        use_rotater = rotater is not None and camera_rot_ids is not None
        if use_rotater and self.optimize_rotations and self.num_rotations > 0:
            rotater = rotater.replace(deltas=self.rotation_opt_deltas)

        def rotate_samples(pos, cam, dirs=None):
            """World -> canonical inside the turntable sphere; cam (n, 1)."""
            rid = camera_rot_ids[cam[..., 0]]
            return rotater.apply_positions_within(rid, pos, dirs, rotation_radius)

        def make_density_fn(net):
            def fn(pos, cam: Optional[torch.Tensor]):
                if use_rotater:
                    pos, _ = rotate_samples(pos, cam)
                return net(pos, disable_aabb=disable_aabb, disable_aabb_on=disable_aabb_on)
            return fn

        if spacing_bins is None:
            ray_samples, weights_list, samples_list = proposal_sample(
                ray_bundle,
                [make_density_fn(net) for net in self.proposal_networks],
                list(self.num_proposal_samples),
                self.num_nerf_samples,
                generator=generator,
                proposal_weights_anneal=proposal_anneal,
                single_jitter=self.single_jitter,
            )
        else:
            ray_samples, weights_list, samples_list = samples_at(ray_bundle, spacing_bins), [], []
        positions = ray_samples.frustums.get_positions()
        dirs = ray_bundle.directions[..., None, :].expand(positions.shape)
        if use_rotater:
            positions, dirs = rotate_samples(positions, ray_samples.camera_indices, dirs)
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
            hdr=self.hdr, is_training=train, generator=generator,
        )
        if hdr_radiance_only:
            return {"rgb": rgb, "spacing_bins": torch.cat([ray_samples.spacing_starts,
                                                           ray_samples.spacing_ends[..., -1:]], dim=-1)}
        outputs = {
            "rgb": rgb,
            "accumulation": rendering.composite_accumulation(weights),
            "depth": rendering.composite_depth(
                weights, ray_samples.frustums.starts, ray_samples.frustums.ends,
                method=self.depth_method,
            ),
        }
        if train:
            outputs["weights_list"] = weights_list + [weights]
            outputs["spacing_bins_list"] = [
                torch.cat([s.spacing_starts, s.spacing_ends[..., -1:]], dim=-1)
                for s in samples_list + [ray_samples]
            ]
            outputs["ray_samples"] = ray_samples
        return outputs

    def point_lights(
        self,
        ray_bundle: RayBundle,
        *,
        disable_aabb=None,
        disable_aabb_on: bool = False,
    ) -> dict[str, torch.Tensor]:
        """Light point-cloud attributes for guiding: per-ray HDR radiance
        over a black background, its luminance, the contrib depth (the
        depth of the sample of largest weight x luminance) and
        d(brightness)/d(origin) along the ray direction, by forward-mode AD
        (`torch.func.jvp`) through the plain forward."""

        def brightness_of(origins):
            out = self(
                ray_bundle.replace(origins=origins), disable_aabb=disable_aabb,
                disable_aabb_on=disable_aabb_on, hdr_radiance_only=True,
            )
            return luminance(out["rgb"])

        _, dbrightness = torch.func.jvp(brightness_of, (ray_bundle.origins,), (ray_bundle.directions,))
        density_fns = [
            lambda pos, cam, net=net: net(pos, disable_aabb=disable_aabb, disable_aabb_on=disable_aabb_on)
            for net in self.proposal_networks
        ]
        ray_samples, _, _ = proposal_sample(
            ray_bundle, density_fns, list(self.num_proposal_samples), self.num_nerf_samples,
        )
        positions = ray_samples.frustums.get_positions()
        density, geo = self.field.get_density(
            positions, disable_aabb=disable_aabb, disable_aabb_on=disable_aabb_on
        )
        dirs = ray_bundle.directions[..., None, :].expand(positions.shape)
        rgb_samples = self.field.get_rgb(geo, dirs, ray_samples.camera_indices)
        weights = ray_samples.get_weights(density)
        rgb = rendering.composite_rgb(rgb_samples, weights, background_color="black", hdr=True,
                                      is_training=False)
        depth = rendering.composite_depth(
            weights, ray_samples.frustums.starts, ray_samples.frustums.ends,
            method="contrib", values=luminance(rgb_samples),
        )
        return {"rgb": rgb, "luminance": luminance(rgb), "depth": depth,
                "brightness_grad": dbrightness}
