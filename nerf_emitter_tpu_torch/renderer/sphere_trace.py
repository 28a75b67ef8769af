"""Sphere tracing with differentiable intersections (port of
nerf_emitter_tpu/renderer/sphere_trace.py).

The march runs without autograd over all rays in lockstep, for a fixed
number of steps, with a done-mask per ray: no early exit, since reading a
flag back to the host each step would serialise the stream. The hit
distance t* is then made differentiable by one implicit-function-theorem
step,

    t(theta) = t* - f(o + t* d; theta) / <grad_x f, d>,

whose value is t* and whose first derivatives are those of the true
intersection with respect to the SDF values, o and d. Silhouette gradients
come from the warp field (reparam.py) or the soft visibility below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils import profiler
from .grid3d import sdf_eval, sdf_eval_nearest, sdf_gradient


@dataclasses.dataclass(frozen=True)
class SphereTraceConfig:
    max_steps: int = 48  # trilinear (fine) steps
    hit_eps: float = 5e-4  # |f| below this counts as a hit
    t_max: float = 4.0  # beyond this the ray escaped
    step_scale: float = 0.9  # Lipschitz safety factor
    bbox_min: float = 0.0
    bbox_max: float = 1.0
    # coarse pre-march on the nearest-node SDF (one gather a step) with a
    # half-voxel-diagonal margin; 0 disables
    coarse_steps: int = 24


def _ray_box_span(o: torch.Tensor, d: torch.Tensor, lo: float, hi: float):
    """(t_enter clamped at 0, t_exit) of each ray through the box [lo, hi]^3."""
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d >= 0, 1e-12, -1e-12), d)
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return torch.clamp(tmin, min=0.0), tmax


def _coarse_march(sdf, o, d, t0, t_exit, config: SphereTraceConfig):
    """Conservative pre-march on the nearest-node SDF with a half-voxel-
    diagonal margin: it stalls within a voxel of the surface and hands
    over to the trilinear phase."""
    if config.coarse_steps <= 0:
        return t0
    margin = 0.87 / (sdf.shape[0] - 1)  # ~ sqrt(3)/2 voxel
    t = t0
    for _ in range(config.coarse_steps):
        f = sdf_eval_nearest(sdf, o + t[:, None] * d)
        step = torch.clamp(config.step_scale * (f - margin), min=0.0)
        t = torch.minimum(t + step, t_exit)
    return t


@profiler.span("render.march")
@torch.no_grad()
def _march(sdf, origins, directions, config: SphereTraceConfig, t_start=None):
    """-> (t (N,), hit (N,) bool, t_closest (N,)): the fixed-step march of
    every ray from its box entry (or t_start, if later). On CUDA it replays
    a captured CUDA graph of the march (`_graphed_march`)."""
    args = (sdf.detach(), origins.detach(), directions.detach(), config, t_start)
    return _graphed_march(*args) if origins.is_cuda else _march_eager(*args)


# CUDA graphs of the march, one per (device, rays, grid shape, config,
# t_start given): the march is ~40 small kernels a step for 72 steps, and
# replaying them as one graph takes the host out of the loop. Each holds
# its static inputs, its outputs and a private memory pool.
_GRAPHS: dict = {}


def clear_march_graphs() -> None:
    """Free the captured marches (and their memory pools)."""
    _GRAPHS.clear()


def _graphed_march(sdf, o, d, config: SphereTraceConfig, t_start):
    key = (o.device, o.shape[0], tuple(sdf.shape), config, t_start is None)
    entry = _GRAPHS.get(key)
    if entry is None:
        static = [x.clone() for x in (sdf, o, d)] + [None if t_start is None else t_start.clone()]
        side = torch.cuda.Stream(device=o.device)
        side.wait_stream(torch.cuda.current_stream(o.device))
        with torch.cuda.stream(side):  # a warm-up outside the capture
            _march_eager(*static[:3], config, static[3])
        torch.cuda.current_stream(o.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _march_eager(*static[:3], config, static[3])
        entry = _GRAPHS[key] = (graph, static, out)
    graph, static, out = entry
    for buf, x in zip(static, (sdf, o, d, t_start)):
        if x is not None:
            buf.copy_(x)
    graph.replay()
    return tuple(x.clone() for x in out)


def _march_eager(sdf, o, d, config: SphereTraceConfig, t_start=None):
    t_enter, t_exit = _ray_box_span(o, d, config.bbox_min, config.bbox_max)
    t_exit = torch.clamp(t_exit, max=config.t_max)
    t0 = t_enter if t_start is None else torch.maximum(t_enter, t_start)
    inactive = t0 >= t_exit  # rays that miss the box
    t = _coarse_march(sdf, o, d, t0, t_exit, config)
    done = inactive
    f_min = torch.full_like(t, 1e9)
    t_min = t
    for _ in range(config.max_steps):
        f = sdf_eval(sdf, o + t[:, None] * d)
        closer = f < f_min
        f_min = torch.where(closer, f, f_min)
        t_min = torch.where(closer, t, t_min)
        done = done | (f.abs() < config.hit_eps) | (t > t_exit)
        t = torch.where(done, t, t + config.step_scale * f)
    f = sdf_eval(sdf, o + t[:, None] * d)
    hit = (f.abs() < config.hit_eps * 4.0) & (t <= t_exit) & ~inactive
    return t, hit, t_min


def sphere_trace(
    sdf: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    config: SphereTraceConfig = SphereTraceConfig(),
    t_start: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """March (N, 3) rays in the unit-cube grid frame to the zero level set.
    Returns (t (N,), hit (N,) bool), detached (see differentiable_hit_t)."""
    t, hit, _ = _march(sdf, origins, directions, config, t_start)
    return t, hit


def sphere_trace_with_closest(
    sdf: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    config: SphereTraceConfig = SphereTraceConfig(),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """sphere_trace plus t_closest, the march's closest approach to the
    surface (argmin of f), for the soft silhouette."""
    return _march(sdf, origins, directions, config)


def soft_visibility(
    sdf: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_closest: torch.Tensor,
    hit: torch.Tensor,
    beta: float = 0.01,
) -> torch.Tensor:
    """Differentiable silhouette indicator in [0, 1]: 1 on hit rays, else
    sigmoid(-f(x_closest) / beta) with f evaluated at the detached
    closest-approach point (the envelope theorem drops dt_closest)."""
    x = origins + t_closest.detach()[:, None] * directions
    soft = torch.sigmoid(-sdf_eval(sdf, x) / beta)
    return torch.where(hit, 1.0, soft)


def differentiable_hit_t(
    sdf: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_star: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Attach the implicit derivatives to a detached hit distance: the
    Newton-step expression below has the value t* and the derivatives
    dt = -df / <grad f, d> with respect to the SDF values, o and d.

    A denominator under eps moves away from 0 on its own side: the
    reference adds +eps to sign(denom) eps, which is 0 for a small negative
    one, so a grazing hit's t (and its pixel, and the loss) is 0/0 = NaN
    there; here it is -2 eps, and the other cases are the reference's."""
    t_det = t_star.detach()
    x = origins + t_det[:, None] * directions
    f = sdf_eval(sdf, x)
    g = sdf_gradient(sdf.detach(), x.detach())
    denom = torch.sum(g * directions.detach(), dim=-1)
    side = torch.where(denom < 0, -1.0, 1.0)
    denom = torch.where(denom.abs() < eps, torch.sign(denom) * eps + side * eps, denom)
    return t_det - (f - f.detach()) / denom


def trace_hit_point(
    sdf: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    config: SphereTraceConfig = SphereTraceConfig(),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable surface intersection: (x (N, 3), t (N,), hit (N,))."""
    t_star, hit = sphere_trace(sdf, origins, directions, config)
    t = differentiable_hit_t(sdf, origins, directions, t_star)
    return origins + t[:, None] * directions, t, hit
