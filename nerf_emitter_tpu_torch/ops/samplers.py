"""Ray samplers: spaced, PDF (inverse-CDF) and proposal sampling (port of
nerf_emitter_tpu/ops/samplers.py).

`generator=None` is the deterministic serving mode (bin centres, the
reference's key=None); a `torch.Generator` gives stratified samples (a
parallel.mesh.RowGenerator: a rank's rows of the whole batch's draws).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..cameras.rays import RayBundle, RaySamples
from ..parallel.mesh import rand

# spacing functions: euclidean distance t -> warped s, and back


def spacing_linear(t):
    return t


def spacing_linear_inv(s):
    return s


def spacing_reciprocal(t):
    return 1.0 / t.clamp(min=1e-10)


def spacing_reciprocal_inv(s):
    return 1.0 / s.clamp(min=1e-10)


def spacing_piecewise(t):
    """Linear for t<1, disparity beyond — nerfacto's UniformLinDispPiecewise."""
    return torch.where(t < 1.0, t / 2.0, 1.0 - 1.0 / (2.0 * t.clamp(min=1e-10)))


def spacing_piecewise_inv(s):
    return torch.where(s < 0.5, 2.0 * s, 1.0 / (2.0 - 2.0 * s).clamp(min=1e-10))


_SPACING_FWD = {
    spacing_piecewise_inv: spacing_piecewise,
    spacing_linear_inv: spacing_linear,
    spacing_reciprocal_inv: spacing_reciprocal,
}


def spaced_sample(
    ray_bundle: RayBundle,
    num_samples: int,
    *,
    generator: Optional[torch.Generator] = None,
    spacing_fn: Callable = spacing_piecewise,
    spacing_fn_inv: Callable = spacing_piecewise_inv,
    single_jitter: bool = True,
) -> RaySamples:
    """Uniform-in-warped-space sampling between near and far."""
    origins = ray_bundle.origins
    n_rays = origins.shape[0]
    bins = torch.linspace(0.0, 1.0, num_samples + 1, device=origins.device)
    bins = bins.expand(n_rays, num_samples + 1)
    if generator is not None:
        shape = (n_rays, 1) if single_jitter else (n_rays, num_samples + 1)
        jitter = rand(shape, generator, origins.device)
        centers = (bins[..., 1:] + bins[..., :-1]) / 2.0
        upper = torch.cat([centers, bins[..., -1:]], dim=-1)
        lower = torch.cat([bins[..., :1], centers], dim=-1)
        bins = lower + (upper - lower) * jitter
    s_near = spacing_fn(ray_bundle.nears)
    s_far = spacing_fn(ray_bundle.fars)
    euclid = spacing_fn_inv(bins * (s_far - s_near) + s_near)
    return ray_bundle.get_ray_samples(
        bin_starts=euclid[..., :-1],
        bin_ends=euclid[..., 1:],
        spacing_starts=bins[..., :-1],
        spacing_ends=bins[..., 1:],
    )


def sample_pdf(
    ray_bundle: RayBundle,
    ray_samples: RaySamples,
    weights: torch.Tensor,
    num_samples: int,
    *,
    generator: Optional[torch.Generator] = None,
    spacing_fn_inv: Callable = spacing_piecewise_inv,
    histogram_padding: float = 0.01,
    single_jitter: bool = True,
) -> RaySamples:
    """Inverse-CDF resampling of `num_samples` new bins from the existing
    weights (n_rays, n_bins). The resample is stop-gradient with respect to
    the weights (mip-NeRF 360 convention, as the reference); ray-geometry
    gradients still flow through near/far and positions."""
    eps = 1e-5
    w = weights.detach() + histogram_padding
    w_sum = w.sum(dim=-1, keepdim=True)
    padding = (eps - w_sum).clamp(min=0.0)
    w = w + padding / w.shape[-1]
    w_sum = w_sum + padding
    pdf = w / w_sum
    cdf = torch.cumsum(pdf[..., :-1], dim=-1).clamp(max=1.0)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf, torch.ones_like(cdf[..., :1])], dim=-1)

    n_rays = cdf.shape[0]
    dev = cdf.device
    if generator is not None:
        shape = (n_rays, 1) if single_jitter else (n_rays, num_samples + 1)
        offsets = rand(shape, generator, dev) / (num_samples + 1)
        u = torch.linspace(0.0, 1.0 - 1.0 / (num_samples + 1), num_samples + 1, device=dev)
        u = u.expand(n_rays, num_samples + 1) + offsets
    else:
        u = torch.linspace(0.0, 1.0 - eps, num_samples + 1, device=dev) + 1.0 / (2 * (num_samples + 1))
        u = u.expand(n_rays, num_samples + 1)

    existing = torch.cat([ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], dim=-1)
    # the piecewise-linear inverse of the CDF as a sum of clamped ramps
    # (the reference's gather-free form): full segments below u add their
    # width, the containing segment its fraction, segments above nothing
    d_cdf = cdf[..., 1:] - cdf[..., :-1]
    d_bins = existing[..., 1:] - existing[..., :-1]
    inv_d_cdf = 1.0 / d_cdf.clamp(min=eps)
    frac = (u[..., :, None] - cdf[..., None, :-1]) * inv_d_cdf[..., None, :]
    new_bins = existing[..., :1] + torch.sum(d_bins[..., None, :] * frac.clamp(0.0, 1.0), dim=-1)

    return samples_at(ray_bundle, new_bins, spacing_fn_inv=spacing_fn_inv)


def samples_at(
    ray_bundle: RayBundle,
    spacing_bins: torch.Tensor,
    *,
    spacing_fn_inv: Callable = spacing_piecewise_inv,
) -> RaySamples:
    """The samples between the spacing edges `spacing_bins` (n_rays, S + 1)
    in warped space, mapped between each ray's near and far: the edges are
    constants, and the samples' distances differentiate by near, far and the
    ray."""
    spacing_fn = _SPACING_FWD[spacing_fn_inv]
    s_near = spacing_fn(ray_bundle.nears)
    s_far = spacing_fn(ray_bundle.fars)
    euclid = spacing_fn_inv(spacing_bins * (s_far - s_near) + s_near)
    return ray_bundle.get_ray_samples(
        bin_starts=euclid[..., :-1],
        bin_ends=euclid[..., 1:],
        spacing_starts=spacing_bins[..., :-1],
        spacing_ends=spacing_bins[..., 1:],
    )


def proposal_sample(
    ray_bundle: RayBundle,
    density_fns: Sequence[Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]],
    num_proposal_samples: Sequence[int],
    num_nerf_samples: int,
    *,
    generator: Optional[torch.Generator] = None,
    proposal_weights_anneal: float = 1.0,
    single_jitter: bool = True,
    spacing_fn: Callable = spacing_piecewise,
    spacing_fn_inv: Callable = spacing_piecewise_inv,
) -> tuple[RaySamples, list[torch.Tensor], list[RaySamples]]:
    """Hierarchical proposal sampling. density_fns[i](positions,
    camera_indices) -> densities (n_rays, S_i). Returns (final samples,
    each level's weights, each level's samples)."""
    weights_list: list[torch.Tensor] = []
    samples_list: list[RaySamples] = []
    ray_samples = None
    weights = None
    for i, n_samp in enumerate(num_proposal_samples):
        if i == 0:
            ray_samples = spaced_sample(
                ray_bundle, n_samp, generator=generator, spacing_fn=spacing_fn,
                spacing_fn_inv=spacing_fn_inv, single_jitter=single_jitter,
            )
        else:
            ray_samples = sample_pdf(
                ray_bundle, ray_samples, weights, n_samp, generator=generator,
                spacing_fn_inv=spacing_fn_inv, single_jitter=single_jitter,
            )
        density = density_fns[i](ray_samples.frustums.get_positions(), ray_samples.camera_indices)
        w = ray_samples.get_weights(density)
        weights_list.append(w)
        samples_list.append(ray_samples)
        weights = torch.pow(w, proposal_weights_anneal)
    final = sample_pdf(
        ray_bundle, ray_samples, weights, num_nerf_samples, generator=generator,
        spacing_fn_inv=spacing_fn_inv, single_jitter=single_jitter,
    )
    return final, weights_list, samples_list
