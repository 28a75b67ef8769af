"""Direct illumination on a sphere-traced SDF with multiple importance
sampling (port of nerf_emitter_tpu/renderer/integrator.py).

Every surface interaction is traced first; then one flat batch of emitter
queries is answered at once, which is the shape the NeRF emitter wants: a
row asks for the surface's secondary ray where the primary ray hits and
for the primary ray where it escapes (its surface answer is never read),
and in MIS 'both' mode the second strategy's rays follow. Escaped rays see
the emitter function `emitter_fn(x, d) -> rgb` (the NeRF) or the scene's
envmap. Curvature and normal-depth render modes serve the regulariser and
the tools.

Randomness: a call draws its uniforms from a `torch.Generator` (or the
global one) or takes them as a `DirectDraws`, so that a checkpointed
recompute, or a test against another package, replays the same samples.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import profiler
from ..utils.math import normalize
from .bsdf import (cosine_sample_hemisphere, diffuse_eval, diffuse_pdf, principled_eval, principled_pdf,
                   principled_sample)
from .grid3d import grid_sample, sdf_eval, sdf_normal
from .reparam import WarpConfig, reparam_direction
from .scene import DIFFUSE, SdfScene
from .sphere_trace import (SphereTraceConfig, differentiable_hit_t, soft_visibility, sphere_trace,
                           sphere_trace_with_closest, trace_hit_point)

EmitterFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, d) -> rgb


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    trace: SphereTraceConfig = SphereTraceConfig()
    shadow_eps: float = 2e-3  # offset along the normal for secondary rays
    use_visibility: bool = True  # trace shadow rays
    guiding_mis_compensation: bool = True
    soft_beta: float = 0.01  # softness of the differentiable silhouette
    # 'both': deterministic MIS, both strategies per ray (lower variance,
    # two secondary rays); 'one_sample': pick the BSDF or the emitter
    # strategy per ray (the reference's onesamplemis), one shadow trace and
    # one emitter query per ray
    mis_mode: str = "both"
    # silhouette gradients: 'warp' reparameterises the primary (and, with
    # warp_secondary, the secondary) directions; 'soft' leaves the boundary
    # signal to the soft_mask output (and a mask loss)
    reparam: str = "warp"
    warp: WarpConfig = WarpConfig()
    warp_secondary: bool = True


@dataclasses.dataclass
class DirectDraws:
    """The random numbers of render_direct for N rays, or of several calls
    stacked on leading axes:
    - strat (N,): the one-sample strategy, the emitter's below 0.5;
    - bsdf: diffuse (u (N, 2),); principled (u_cos (N, 2), u_ggx (N, 2),
      u_pick (N,));
    - emit: vMF guiding (u_lobe, u_cos, u_phi), each (N,); envmap (u_row
      (N,), u_col (N,), jitter (N, 2)); the uniform-sphere fallback a
      normal draw (N, 3)."""

    strat: torch.Tensor
    bsdf: tuple
    emit: tuple

    def map(self, fn) -> "DirectDraws":
        return DirectDraws(fn(self.strat), tuple(fn(t) for t in self.bsdf), tuple(fn(t) for t in self.emit))


def draw_direct(scene: SdfScene, n: int, generator: Optional[torch.Generator] = None, device=None,
                lead: tuple = ()) -> DirectDraws:
    """Draw render_direct's random numbers for n rays (with leading axes
    `lead`, e.g. (spp,))."""
    device = scene.sdf.device if device is None else device
    shape = (*lead, n)

    def u(*tail):
        return torch.rand((*shape, *tail), generator=generator, device=device)

    bsdf = (u(2),) if scene.bsdf_type == DIFFUSE else (u(2), u(2), u())
    if scene.guiding is not None:
        emit = (u(), u(), u())
    elif scene.envmap is not None:
        emit = (u(), u(), u(2))
    else:
        emit = (torch.randn((*shape, 3), generator=generator, device=device),)
    return DirectDraws(u(), bsdf, emit)


def _bsdf_eval(scene: SdfScene, x, n, wi, wo):
    albedo = grid_sample(scene.albedo, x)
    if scene.bsdf_type == DIFFUSE:
        return diffuse_eval(albedo, n, wo)
    return principled_eval(albedo, grid_sample(scene.roughness, x), n, wi, wo)


def _bsdf_pdf(scene: SdfScene, x, n, wi, wo):
    if scene.bsdf_type == DIFFUSE:
        return diffuse_pdf(n, wo)
    return principled_pdf(grid_sample(scene.roughness, x), n, wi, wo)


def _bsdf_sample(u, scene: SdfScene, x, n, wi):
    if scene.bsdf_type == DIFFUSE:
        return cosine_sample_hemisphere(n, u[0])
    return principled_sample(grid_sample(scene.roughness, x), n, wi, *u)


def _emitter_sample(u, scene: SdfScene, x):
    """An emitter-strategy direction at shading points x: from the guiding
    mixture, else the envmap, else uniform on the sphere."""
    if scene.guiding is not None:
        return scene.guiding.sample(x, uniforms=u)
    if scene.envmap is not None:
        return scene.envmap.sample(x.shape[:-1], uniforms=u)
    return normalize(u[0]), torch.full(x.shape[:-1], 1.0 / (4.0 * math.pi), device=x.device)


def _emitter_pdf(scene: SdfScene, x, d):
    if scene.guiding is not None:
        return scene.guiding.pdf(x, d)
    if scene.envmap is not None:
        return scene.envmap.pdf(d)
    return torch.full(x.shape[:-1], 1.0 / (4.0 * math.pi), device=x.device)


def _in_backward() -> bool:
    """Whether autograd is running a backward here (a checkpoint's
    recompute, say)."""
    return torch._C._current_graph_task_id() != -1


def _count_asked(x: torch.Tensor, d: torch.Tensor) -> None:
    """The tracing counters of one emitter call of n rows: emitter.rays (and
    emitter.grad_rays where the rays carry a gradient) outside a backward,
    emitter.rerun_rays inside one."""
    n = x.shape[0]
    if _in_backward():
        profiler.count("emitter.rerun_rays", n)
        return
    profiler.count("emitter.rays", n)
    if torch.is_grad_enabled() and (x.requires_grad or d.requires_grad):
        profiler.count("emitter.grad_rays", n)


def _count_rows(name: str, rows: torch.Tensor) -> None:
    """A counter of the emitter rows that the mask `rows` marks (a sum on the
    device), outside a backward, as emitter.rays counts: emitter.used_rays,
    the answers that the estimate keeps; emitter.merged_rays, the rows that
    ask for an escaped primary ray."""
    if not _in_backward():
        profiler.count(name, rows.sum())


def render_direct(
    scene: SdfScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    draws: Optional[DirectDraws] = None,
    emitter_fn: Optional[EmitterFn] = None,
    config: RenderConfig = RenderConfig(),
) -> dict[str, torch.Tensor]:
    """One-sample direct-illumination estimate for (N, 3) rays in render
    space. emitter_fn overrides the envmap for radiance; sampling and pdfs
    still come from scene.guiding or scene.envmap. Returns 'rgb' (N, 3),
    'hit' (N,), 'alpha' (N,), 'soft_mask' (N,), 'depth' (N,), 'normal'
    (N, 3)."""
    n_rays = origins.shape[0]
    if draws is None:
        draws = draw_direct(scene, n_rays, generator, origins.device)
    use_warp = config.reparam == "warp"
    count_used = emitter_fn is not None and profiler.enabled()

    def radiance(x, d):
        """The emitter's answers for the rows (x, d): one call."""
        if emitter_fn is not None:
            with profiler.span("emitter.forward"):
                if profiler.enabled():
                    _count_asked(x, d)
                return emitter_fn(x, d)
        if scene.envmap is not None:
            return scene.envmap.eval(d)
        return torch.zeros((*d.shape[:-1], 3), device=d.device)

    # the warp of the primary directions: primal unchanged, derivatives
    # with the silhouette's boundary terms
    if use_warp:
        dirs, jac = reparam_direction(scene.sdf, origins, directions, config.trace, config.warp)
    else:
        dirs, jac = directions, None

    def warp_secondary(x_from, d):
        """Reparameterise a secondary direction; pdfs stay at the primal d."""
        if use_warp and config.warp_secondary:
            return reparam_direction(scene.sdf, x_from, d, config.trace, config.warp)
        return d, None

    def visible(x_from, d):
        if config.use_visibility:
            return ~sphere_trace(scene.sdf, x_from, d, config.trace)[1]
        return torch.ones(n_rays, dtype=torch.bool, device=d.device)

    # the primary intersection (differentiable) and the soft silhouette
    t_star, hit, t_closest = sphere_trace_with_closest(scene.sdf, origins, dirs, config.trace)
    t = differentiable_hit_t(scene.sdf, origins, dirs, t_star)
    x = origins + t[:, None] * dirs
    # soft_mask stays on the unwarped directions: the warp's noisier
    # divergence term degrades mask-supervised convergence
    soft_mask = soft_visibility(scene.sdf, origins, directions, t_closest, hit, beta=config.soft_beta)
    n = sdf_normal(scene.sdf, x)
    n = torch.where(torch.sum(n * dirs, dim=-1, keepdim=True) > 0, -n, n)  # face the viewer
    wi = -dirs
    x_off = x + config.shadow_eps * n

    # each term of the estimate: its secondary direction (warped), its
    # visibility, f, its weight and the warp's area factor
    if config.mis_mode == "one_sample":
        # pick the BSDF or the emitter strategy per ray; with the balance
        # heuristic the estimator is 2 f L V / (pdf_e + pdf_b) at the one
        # chosen direction: one shadow trace and one emitter query per ray
        d_e, _ = _emitter_sample(draws.emit, scene, x_off)
        d_b, _ = _bsdf_sample(draws.bsdf, scene, x, n, wi)
        d = torch.where((draws.strat < 0.5)[:, None], d_e, d_b)
        pdf_e_d = _emitter_pdf(scene, x_off, d)
        pdf_b_d = _bsdf_pdf(scene, x, n, wi, d)
        d_w, jac_s = warp_secondary(x_off, d)
        f = _bsdf_eval(scene, x, n, wi, d_w)
        vis = visible(x_off, d_w)
        terms = [(d_w, vis, f, 2.0 / torch.clamp(pdf_e_d + pdf_b_d, min=1e-9), jac_s)]
    else:
        # strategy A, emitter sampling
        d_e, pdf_e = _emitter_sample(draws.emit, scene, x_off)
        pdf_e_b = _bsdf_pdf(scene, x, n, wi, d_e)
        d_e_w, jac_e = warp_secondary(x_off, d_e)
        f_e = _bsdf_eval(scene, x, n, wi, d_e_w)
        vis_e = visible(x_off, d_e_w)
        w_mis_e = pdf_e / torch.clamp(pdf_e + pdf_e_b, min=1e-9)
        # strategy B, BSDF sampling
        d_b, pdf_b = _bsdf_sample(draws.bsdf, scene, x, n, wi)
        pdf_b_e = _emitter_pdf(scene, x_off, d_b)
        d_b_w, jac_b = warp_secondary(x_off, d_b)
        f_b = _bsdf_eval(scene, x, n, wi, d_b_w)
        vis_b = visible(x_off, d_b_w)
        w_mis_b = pdf_b / torch.clamp(pdf_b + pdf_b_e, min=1e-9)
        terms = [(d_e_w, vis_e, f_e, w_mis_e / torch.clamp(pdf_e, min=1e-9), jac_e),
                 (d_b_w, vis_b, f_b, w_mis_b / torch.clamp(pdf_b, min=1e-9), jac_b)]

    # the emitter's answers. Escaped primary rays see the emitter directly;
    # where it is visible, one call answers them with the terms: the
    # estimate reads a term's answer only where the primary ray hits, so
    # where it escapes the first term's row asks for the primary ray in its
    # place, and the second term's rows (MIS 'both') follow
    if scene.hide_emitters:
        answers = [radiance(x_off, term[0]) for term in terms]
        miss_rgb = torch.zeros((n_rays, 3), device=origins.device)
    else:
        esc = ~hit[:, None]
        x_q = torch.where(esc, origins, x_off)
        d_q = torch.where(esc, dirs, terms[0][0])
        if len(terms) > 1:
            x_q, d_q = torch.cat([x_q, x_off]), torch.cat([d_q, terms[1][0]])
        answers = radiance(x_q, d_q).split(n_rays)
        miss_rgb = answers[0]
    if count_used:
        kept = [hit & term[1] for term in terms]
        if not scene.hide_emitters:
            kept[0] = kept[0] | ~hit
            _count_rows("emitter.merged_rays", ~hit)
        for k in kept:
            _count_rows("emitter.used_rays", k)

    surface_rgb = None
    for (_, vis, f, w, jac_t), le in zip(terms, answers):
        term_rgb = torch.where(vis[:, None], f * le * w[:, None], 0.0)
        if jac_t is not None:
            term_rgb = term_rgb * jac_t[:, None]
        surface_rgb = term_rgb if surface_rgb is None else surface_rgb + term_rgb
    rgb = torch.where(hit[:, None], surface_rgb, miss_rgb)
    if jac is not None:
        # the primary warp's area factor (primal 1) carries the silhouette
        # boundary gradient of the image and of the alpha
        rgb = rgb * jac[:, None]
        alpha = hit.to(rgb.dtype) * jac
    else:
        alpha = soft_mask
    return {
        "rgb": rgb,
        "hit": hit,
        "alpha": alpha,
        "soft_mask": soft_mask,
        "depth": torch.where(hit, t, 0.0),
        "normal": torch.where(hit[:, None], n, 0.0),
    }


_SPP_KEYS = ("rgb", "hit", "alpha", "soft_mask", "depth", "normal")


def render_spp(
    scene: SdfScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    spp: int,
    generator: Optional[torch.Generator] = None,
    *,
    draws: Optional[DirectDraws] = None,
    emitter_fn: Optional[EmitterFn] = None,
    config: RenderConfig = RenderConfig(),
    remat: bool = True,
    spp_per_batch: int = 0,
) -> dict[str, torch.Tensor]:
    """The mean of `spp` one-sample estimates, in slices of spp_per_batch
    samples (1 when it does not divide spp). A slice stacks its samples on
    the ray axis, so an emitter query sees rays x spp_per_batch rays. With
    remat (and grad enabled) each slice runs under a non-reentrant
    torch.utils.checkpoint: its intermediates are recomputed in the
    backward, so memory stays flat in spp and the gradient is exact for
    every sample. The draws, (spp, N)-leading, come from `generator` or
    `draws` and are fixed before any slice runs, so the recompute replays
    the same samples."""
    n = origins.shape[0]
    b = max(1, spp_per_batch)
    if spp % b != 0:
        b = 1
    if draws is None:
        draws = draw_direct(scene, n, generator, origins.device, lead=(spp,))
    o_b, d_b = origins.repeat(b, 1), directions.repeat(b, 1)

    def one(dr: DirectDraws):
        out = render_direct(scene, o_b, d_b, draws=dr, emitter_fn=emitter_fn, config=config)
        rgb = out["rgb"].reshape(b, n, 3).mean(dim=0)
        alpha = out["alpha"].reshape(b, n).mean(dim=0)
        return rgb, out["hit"][:n], alpha, out["soft_mask"][:n], out["depth"][:n], out["normal"][:n]

    outs = []
    for c in range(spp // b):
        dr = draws.map(lambda t, c=c: t[c * b:(c + 1) * b].reshape(b * n, *t.shape[2:]))
        if remat and torch.is_grad_enabled():
            outs.append(checkpoint(one, dr, use_reentrant=False, preserve_rng_state=False))
        else:
            outs.append(one(dr))
    first = dict(zip(_SPP_KEYS, outs[0]))
    first["rgb"] = torch.stack([o[0] for o in outs]).mean(dim=0)
    # alpha is stochastic only through the warp's jacobian: average it
    first["alpha"] = torch.stack([o[2] for o in outs]).mean(dim=0)
    return first


def render_curvature(
    scene: SdfScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    config: RenderConfig = RenderConfig(),
    curvature_epsilon: float = 5e-3,
) -> torch.Tensor:
    """|mean curvature| image (the curvature regulariser's integrator): the
    finite-difference Laplacian of the SDF at hit points, 0 elsewhere."""
    x, _, hit = trace_hit_point(scene.sdf, origins, directions, config.trace)
    e = curvature_epsilon
    off = torch.eye(3, device=x.device) * e
    pts = torch.stack([x] + [x + s * off[a] for a in range(3) for s in (1.0, -1.0)])
    f = sdf_eval(scene.sdf, pts)
    lap = -6.0 * f[0]
    for a in range(3):
        lap = lap + f[1 + 2 * a] + f[2 + 2 * a]
    return torch.where(hit, torch.abs(lap / (e * e)), 0.0)


def render_normal_depth(
    scene: SdfScene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    config: RenderConfig = RenderConfig(),
) -> dict[str, torch.Tensor]:
    """Normals and depth at the hits (the normal-depth integrator)."""
    x, t, hit = trace_hit_point(scene.sdf, origins, directions, config.trace)
    n = sdf_normal(scene.sdf, x)
    return {"normal": torch.where(hit[:, None], n, 0.0), "depth": torch.where(hit, t, 0.0), "hit": hit}
