"""SDF and texture optimisation (port of nerf_emitter_tpu/renderer/optimize.py):
regularisers, redistancing, the gradient transforms, the variables and the
named recipes, the clamps and the upsample schedule, as plain functions on
the SdfScene.

The gradient transforms have optax's form on one tensor: `init(param) ->
state` and `update(grad, state) -> (update, state)`, the update added to
the parameter. `adam` is optax.adam; `sobolev_preconditioner` and
`uniform_adam` are the reference's own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from .grid3d import upsample_grid
from .scene import DIFFUSE, PRINCIPLED, SdfScene

# ---- regularisers


def laplacian_reg(grid: torch.Tensor) -> torch.Tensor:
    """Mean squared discrete Laplacian of an (R, R, R, C) grid's interior."""
    g = grid
    lap = -6.0 * g[1:-1, 1:-1, 1:-1]
    lap = lap + g[:-2, 1:-1, 1:-1] + g[2:, 1:-1, 1:-1]
    lap = lap + g[1:-1, :-2, 1:-1] + g[1:-1, 2:, 1:-1]
    lap = lap + g[1:-1, 1:-1, :-2] + g[1:-1, 1:-1, 2:]
    return torch.mean(lap**2)


def _pad_edge(u: torch.Tensor) -> torch.Tensor:
    """Replicate the edge nodes of (R, R, R) or (R, R, R, C) by one node."""
    if u.dim() == 3:
        return F.pad(u[None, None], (1,) * 6, mode="replicate")[0, 0]
    return F.pad(u.permute(3, 0, 1, 2)[None], (1,) * 6, mode="replicate")[0].permute(1, 2, 3, 0)


def smooth_gradient(g: torch.Tensor, lam: float, n_iters: int = 16) -> torch.Tensor:
    """Sobolev preconditioning of a voxel gradient: about (I + lam L)^-1 g,
    L the 6-neighbour graph Laplacian, by Jacobi iteration (the role of the
    reference's sparse Cholesky in the 'hqq' recipes; Nicolet et al. 2021).
    Edge replication is the Neumann boundary: a border node's missing
    neighbour counts as itself. (I + lam L) is strictly diagonally
    dominant, so 16 iterations reach sub-percent residuals."""
    if lam <= 0.0:
        return g
    squeeze = g.dim() == 4 and g.shape[-1] == 1
    rhs = g[..., 0] if squeeze else g

    def neighbour_sum(u):
        ue = _pad_edge(u)
        return (ue[:-2, 1:-1, 1:-1] + ue[2:, 1:-1, 1:-1] + ue[1:-1, :-2, 1:-1]
                + ue[1:-1, 2:, 1:-1] + ue[1:-1, 1:-1, :-2] + ue[1:-1, 1:-1, 2:])

    u = rhs / (1.0 + 6.0 * lam)
    for _ in range(n_iters):
        u = (rhs + lam * neighbour_sum(u)) / (1.0 + 6.0 * lam)
    return u[..., None] if squeeze else u


def eikonal_residual(sdf: torch.Tensor) -> torch.Tensor:
    """Mean | |grad f| - 1 | over the interior nodes (central differences)."""
    g = sdf[..., 0] if sdf.dim() == 4 else sdf
    h = 1.0 / (g.shape[0] - 1)
    dx = (g[2:, 1:-1, 1:-1] - g[:-2, 1:-1, 1:-1]) / (2 * h)
    dy = (g[1:-1, 2:, 1:-1] - g[1:-1, :-2, 1:-1]) / (2 * h)
    dz = (g[1:-1, 1:-1, 2:] - g[1:-1, 1:-1, :-2]) / (2 * h)
    return torch.mean(torch.abs(torch.sqrt(dx**2 + dy**2 + dz**2 + 1e-12) - 1.0))


# ---- gradient transforms


class GradientTransform(NamedTuple):
    """init(param) -> state; update(grad, state) -> (update, state)."""

    init: Callable
    update: Callable


def chain(*txs: GradientTransform) -> GradientTransform:
    def update(g, state):
        out = []
        for tx, s in zip(txs, state):
            g, s = tx.update(g, s)
            out.append(s)
        return g, tuple(out)

    return GradientTransform(lambda p: tuple(tx.init(p) for tx in txs), update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransform:
    """optax.adam: bias-corrected moments, -lr m_hat / (sqrt(v_hat) + eps)."""

    def update(g, state):
        count = state["count"] + 1
        mu = (1.0 - b1) * g + b1 * state["mu"]
        nu = (1.0 - b2) * (g * g) + b2 * state["nu"]
        mu_hat = mu / (1.0 - b1**count)
        nu_hat = nu / (1.0 - b2**count)
        return -lr * (mu_hat / (torch.sqrt(nu_hat) + eps)), dict(mu=mu, nu=nu, count=count)

    return GradientTransform(lambda p: dict(mu=torch.zeros_like(p), nu=torch.zeros_like(p), count=0), update)


def sobolev_preconditioner(lam: float, n_iters: int = 16) -> GradientTransform:
    """smooth_gradient as a transform; chained before the moment step."""
    return GradientTransform(lambda p: (), lambda g, s: (smooth_gradient(g, lam, n_iters), s))


def uniform_adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransform:
    """Adam with one scalar second moment per variable, an infinity-norm
    tracker with EMA decay (Nicolet et al. 2021's UniformAdam).
    Per-coordinate Adam divides each voxel's update by its own RMS and so
    re-amplifies the high frequencies the Sobolev step removed; a scalar
    keeps the smoothed direction and the step size's adaptivity."""

    def update(g, state):
        count = state["count"] + 1
        mu = b1 * state["mu"] + (1.0 - b1) * g
        nu = torch.maximum(b2 * state["nu"], torch.amax(torch.abs(g)).float() ** 2)
        bc = 1.0 - b1**count
        return (-lr / bc) * mu / (torch.sqrt(nu) + eps), dict(mu=mu, nu=nu, count=count)

    return GradientTransform(
        lambda p: dict(mu=torch.zeros_like(p), nu=torch.zeros((), device=p.device), count=0), update)


# ---- redistancing


def redistance(sdf: torch.Tensor, n_iters: int = 100) -> torch.Tensor:
    """Rebuild a signed distance function from the zero level set: the
    Godunov upwind discretisation of |grad f| = 1 by Jacobi iteration with
    the interface pinned. Nodes next to a sign change keep a first-order
    distance estimate; the rest relax toward the eikonal solution."""
    squeeze = sdf.dim() == 4
    f = sdf[..., 0] if squeeze else sdf
    h = 1.0 / (f.shape[0] - 1)
    sign = torch.sign(f)
    # the frozen interface band: every node with a neighbour of the other
    # sign (or a zero), the neighbours taken periodically
    band = torch.zeros_like(f, dtype=torch.bool)
    for ax in range(3):
        for d in (-1, 1):
            band = band | (sign * torch.roll(sign, d, dims=ax) <= 0)
    # the band's first-order distance |f| / |grad f| (central differences),
    # exact for an affine-scaled SDF
    fe = _pad_edge(f)
    gx = (fe[2:, 1:-1, 1:-1] - fe[:-2, 1:-1, 1:-1]) / (2 * h)
    gy = (fe[1:-1, 2:, 1:-1] - fe[1:-1, :-2, 1:-1]) / (2 * h)
    gz = (fe[1:-1, 1:-1, 2:] - fe[1:-1, 1:-1, :-2]) / (2 * h)
    phi = torch.abs(f) / torch.clamp(torch.sqrt(gx**2 + gy**2 + gz**2 + 1e-12), min=1e-3)

    u = torch.where(band, phi, 1e9)
    for _ in range(n_iters):
        up = F.pad(u, (1,) * 6, value=1e9)
        a = torch.minimum(up[:-2, 1:-1, 1:-1], up[2:, 1:-1, 1:-1])
        b = torch.minimum(up[1:-1, :-2, 1:-1], up[1:-1, 2:, 1:-1])
        c = torch.minimum(up[1:-1, 1:-1, :-2], up[1:-1, 1:-1, 2:])
        lo = torch.minimum(torch.minimum(a, b), c)
        hi = torch.maximum(torch.maximum(a, b), c)
        mid = a + b + c - lo - hi
        u1 = lo + h  # one axis upwind
        u2 = 0.5 * (lo + mid + torch.sqrt(torch.clamp(2.0 * h * h - (lo - mid) ** 2, min=0.0)))  # two
        s3 = lo + mid + hi
        u3 = (s3 + torch.sqrt(torch.clamp(s3**2 - 3.0 * (lo**2 + mid**2 + hi**2 - h * h), min=0.0))) / 3.0
        # plain Jacobi: transient underestimates pass with the wavefront;
        # it converges to the discrete viscosity solution from any start
        u = torch.where(band, phi, torch.where(u1 <= mid, u1, torch.where(u2 <= hi, u2, u3)))
    # capped at the unit cube's diagonal, so an empty zero set stays finite
    out = sign * torch.clamp(u, max=3.0**0.5)
    out = torch.where(sign == 0, 0.0, out)
    return out[..., None] if squeeze else out


# ---- variables and recipes


@dataclasses.dataclass(frozen=True)
class VariableSpec:
    """One optimised scene tensor (the reference's SdfVariable and
    VolumeVariable)."""

    name: str  # 'sdf' | 'albedo' | 'roughness'
    lr: float
    clamp: Optional[tuple[float, float]] = None
    regularizer_weight: float = 0.0
    redistance_freq: int = 0  # steps; 0 = never
    upsample_iters: tuple[int, ...] = ()
    upsample_factor: int = 2
    # Sobolev smoothing strength of the gradient (the 'hqq' recipes); 0 = off
    smooth_lam: float = 0.0
    # 'adam' (per coordinate) | 'uniform_adam' (scalar second moment,
    # needed with smooth_lam > 0: per-coordinate normalisation undoes the
    # smoothing and roughens the surface)
    optimizer: str = "adam"
    # lr multiplier at each volume upsample (1.0 = off): 8x the voxels
    # carry higher-frequency modes at the same step size
    lr_decay_at_up: float = 1.0


@dataclasses.dataclass(frozen=True)
class SdfOptConfig:
    """A named recipe, '<bsdf>-<res pow>-<loss>-<quality>' (the reference's
    get_opt_config)."""

    name: str
    bsdf_type: int
    loss: str  # a key of ops.losses.RGB_LOSSES
    mask_loss_mult: float = 10.0
    variables: Sequence[VariableSpec] = ()
    batch_size: int = 4  # images per step
    init_res: int = 64
    tex_res: int = 32
    render_upsample_iter: tuple[int, ...] = (64, 128, 192)
    curvature_mult: float = 0.005
    curvature_spp: int = 2
    # finite-difference epsilon ~1.5 voxels at init_res: sub-voxel steps
    # measure the interpolant's kinks, not the surface's curvature
    curvature_epsilon: float = 0.025
    n_steps: int = 320


def _default_variables(lr: float, upsample: tuple[int, ...]) -> tuple[VariableSpec, ...]:
    return (
        # redistancing every 5 steps (every step jitters the zero set and
        # roughens the surface), Sobolev-smoothed gradients with a scalar
        # second moment, and the lr quartered at each volume upsample
        VariableSpec("sdf", lr=lr, clamp=(-1.0, 1.0), regularizer_weight=1e-5, redistance_freq=5,
                     upsample_iters=upsample, smooth_lam=2.0, optimizer="uniform_adam", lr_decay_at_up=0.25),
        VariableSpec("albedo", lr=lr * 1.5, clamp=(0.0, 1.0)),
        VariableSpec("roughness", lr=lr, clamp=(0.02, 1.0)),
    )


OPT_CONFIGS: dict[str, SdfOptConfig] = {
    cfg.name: cfg
    for cfg in (
        SdfOptConfig(name="diffuse-12-relativel1-hqq", bsdf_type=DIFFUSE, loss="relative_l1",
                     variables=_default_variables(3e-3, (64, 128)), init_res=64),
        # one upsample (64 -> 127): at a 128^2 capture a 127^3 grid already
        # out-resolves the pixels
        SdfOptConfig(name="diffuse-12-relativel1-hqq-r128", bsdf_type=DIFFUSE, loss="relative_l1",
                     variables=_default_variables(3e-3, (64,)), init_res=64),
        SdfOptConfig(name="principled-12-relativel1-hqq", bsdf_type=PRINCIPLED, loss="relative_l1",
                     variables=_default_variables(3e-3, (64, 128)), init_res=64),
        SdfOptConfig(name="principled-12-relativemaxl1-hqq-unirough", bsdf_type=PRINCIPLED,
                     loss="relative_max_l1", variables=_default_variables(3e-3, (64, 128)), init_res=64,
                     tex_res=32),
    )
}


def get_opt_config(name: str) -> SdfOptConfig:
    if name not in OPT_CONFIGS:
        raise KeyError(f"unknown opt config {name!r}; have {sorted(OPT_CONFIGS)}")
    return OPT_CONFIGS[name]


@torch.no_grad()
def validate_params(scene: SdfScene, config: SdfOptConfig, step: int) -> SdfScene:
    """After a step: the clamps (not the SDF's) and the scheduled
    redistancing."""
    updates = {}
    for var in config.variables:
        val = getattr(scene, var.name)
        if var.clamp is not None and var.name != "sdf":
            val = torch.clamp(val, var.clamp[0], var.clamp[1])
        if var.name == "sdf" and var.redistance_freq > 0 and step % var.redistance_freq == 0:
            val = redistance(val)
        updates[var.name] = val
    return scene.replace(**updates)


@torch.no_grad()
def maybe_upsample(scene: SdfScene, config: SdfOptConfig, step: int) -> SdfScene:
    """The volume upsample schedule, R -> 2R - 1 at the SDF variable's
    upsample_iters (render_upsample_iter drives the render resolution, not
    the grid's): from 64, two upsamples end at 253^3."""
    spec = next((v for v in config.variables if v.name == "sdf"), None)
    iters = spec.upsample_iters if spec is not None else config.render_upsample_iter
    if step in iters:
        scene = scene.replace(sdf=upsample_grid(scene.sdf, scene.sdf.shape[0] * 2 - 1))
    return scene


def validate_gradients(grads: dict) -> dict:
    """Non-finite gradient entries reset to zero; a missing gradient (a
    variable the loss does not reach) stays None."""
    return {k: None if g is None else torch.where(torch.isfinite(g), g, 0.0) for k, g in grads.items()}
