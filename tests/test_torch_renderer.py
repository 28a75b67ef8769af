"""The port's SDF renderer against the JAX package: the grid functions and
the closed-form gradient, the tracers, the implicit hit derivative, the
BSDFs, the envmap, the sensors and the sample-count schedule
(tests/test_torch_integrator.py holds the integrator). The scenes, rays
and JAX's draws here are shared with the other SDF test files.

The JAX references run under jax.jit (one compile each, cheaper than
eager dispatch), except where a test says otherwise. JAX keys and torch
generators never agree: `j_direct_draws` reproduces
the draws JAX makes from a key (render_direct's split into three, the
bernoulli as uniform < 0.5, the categorical lobe as a uniform inside its
CDF interval) and hands them to the port. Where f32 rounding in another
order flips a grazing ray's hit, the share of flipped rays is held, then
the rest tightly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.cameras import Cameras as JCameras
from nerf_emitter_tpu.renderer import bsdf as jb
from nerf_emitter_tpu.renderer import emitters as je
from nerf_emitter_tpu.renderer import grid3d as jg
from nerf_emitter_tpu.renderer import sensors as jsen
from nerf_emitter_tpu.renderer import spp_schedule as jspp
from nerf_emitter_tpu.renderer import sphere_trace as jst
from nerf_emitter_tpu.renderer.scene import SdfScene as JScene
from nerf_emitter_tpu_torch.bridge import load_sdf_scene
from nerf_emitter_tpu_torch.cameras.cameras import Cameras
from nerf_emitter_tpu_torch.renderer import bsdf as tb
from nerf_emitter_tpu_torch.renderer import emitters as te
from nerf_emitter_tpu_torch.renderer import grid3d as tg
from nerf_emitter_tpu_torch.renderer import integrator as ti
from nerf_emitter_tpu_torch.renderer import sensors as tsen
from nerf_emitter_tpu_torch.renderer import spp_schedule as tspp
from nerf_emitter_tpu_torch.renderer import sphere_trace as tst

torch.set_num_threads(1)

RES = 17
N_SIDE = 8  # 64 rays
TRACE = dict(max_steps=32, coarse_steps=8, t_max=3.0)
# the share of rays whose hit may flip between the packages (f32 sums in
# another order on a grazing ray)
FLIP_SHARE = 0.05


def t_(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(a, b, rtol, atol, mask=None):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---- JAX's draws, for the port


def j_direct_draws(key, jscene, n: int) -> ti.DirectDraws:
    """The random numbers JAX's render_direct draws from `key` for n rays,
    as the port's DirectDraws."""
    k_strat, k_bsdf, k_emit = jax.random.split(key, 3)
    strat = jax.random.uniform(k_strat, (n,))
    if jscene.bsdf_type == 0:
        bsdf = (jax.random.uniform(k_bsdf, (n, 2)),)
    else:
        k1, k2, k3 = jax.random.split(k_bsdf, 3)
        bsdf = (jax.random.uniform(k1, (n, 2)), jax.random.uniform(k2, (n, 2)), jax.random.uniform(k3, (n,)))
    if jscene.guiding is not None:
        k1, k2, k3 = jax.random.split(k_emit, 3)
        w = jscene.guiding.weights / jnp.maximum(jnp.sum(jscene.guiding.weights), 1e-12)
        comp = np.asarray(jax.random.categorical(k1, jnp.log(w + 1e-12)[None, :].repeat(n, 0)))
        cdf = np.cumsum(np.asarray(w, np.float64))
        mid = (np.concatenate([[0.0], cdf[:-1]]) + cdf) / 2.0
        emit = (mid[comp], jax.random.uniform(k2, (n,)), jax.random.uniform(k3, (n,)))
    elif jscene.envmap is not None:
        k1, k2, k3 = jax.random.split(k_emit, 3)
        emit = (jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,)), jax.random.uniform(k3, (n, 2)))
    else:
        emit = (jax.random.normal(k_emit, (n, 3)),)
    return ti.DirectDraws(t_(strat), tuple(t_(x) for x in bsdf), tuple(t_(x) for x in emit))


def stack_draws(draws: list) -> ti.DirectDraws:
    return ti.DirectDraws(torch.stack([d.strat for d in draws]),
                          tuple(torch.stack(x) for x in zip(*[d.bsdf for d in draws])),
                          tuple(torch.stack(x) for x in zip(*[d.emit for d in draws])))


def j_spp_draws(key, jscene, n: int, spp: int) -> ti.DirectDraws:
    """render_spp's draws: one render_direct key per sample."""
    return stack_draws([j_direct_draws(k, jscene, n) for k in jax.random.split(key, spp)])


# ---- scenes and rays shared by the module


def _envmap_image():
    rng = np.random.default_rng(3)
    return (rng.uniform(0.2, 2.0, size=(8, 16, 3)) * np.linspace(0.5, 1.5, 8)[:, None, None]).astype(np.float32)


def _mixture():
    rng = np.random.default_rng(4)
    return (rng.uniform(0.0, 1.0, size=(4, 3)).astype(np.float32), rng.uniform(0.2, 1.0, size=4).astype(np.float32),
            rng.uniform(0.1, 0.6, size=4).astype(np.float32))


def scene_pair(emitter: str, bsdf_type: int = 0, res: int = RES):
    """(JAX scene, port scene): the composite object, a textured albedo,
    lit by an envmap ('envmap') or proposed by a vMF mixture ('vmf')."""
    rng = np.random.default_rng(5)
    albedo = rng.uniform(0.2, 0.9, size=(4, 4, 4, 3)).astype(np.float32)
    rough = rng.uniform(0.2, 0.8, size=(4, 4, 4, 1)).astype(np.float32)
    env = je.EnvmapEmitter.create(jnp.asarray(_envmap_image())) if emitter == "envmap" else None
    guide = je.VMFMixture(*(jnp.asarray(x) for x in _mixture())) if emitter == "vmf" else None
    js = JScene(sdf=jg.composite_sdf_grid(res), albedo=jnp.asarray(albedo), roughness=jnp.asarray(rough),
                envmap=env, guiding=guide, bsdf_type=bsdf_type)
    return js, load_sdf_scene(js)


def pinhole_rays(n_side=N_SIDE, cam=(0.5, 0.55, -0.45), span=(0.28, 0.72)):
    """Rays from one point through an n_side^2 grid on the plane z = 0.5."""
    xs = np.linspace(*span, n_side)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    tgt = np.stack([gx, gy, np.full_like(gx, 0.5)], -1).reshape(-1, 3)
    o = np.broadcast_to(np.asarray(cam), tgt.shape)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def emitter_fns():
    """A smooth emitter function of (x, d) on both sides."""
    def j_fn(x, d):
        return 1.0 + 0.5 * jnp.stack([d[:, 0], d[:, 1] * x[:, 2], jnp.sin(3.0 * d[:, 2]) * x[:, 0]], -1) ** 2

    def t_fn(x, d):
        return 1.0 + 0.5 * torch.stack([d[:, 0], d[:, 1] * x[:, 2], torch.sin(3.0 * d[:, 2]) * x[:, 0]], -1) ** 2

    return j_fn, t_fn


@pytest.fixture(scope="module")
def sdf_np():
    return np.asarray(jax.jit(lambda: jg.composite_sdf_grid(RES))())


# ---- grids


def test_grid_functions_match_jax(sdf_np):
    """grid_sample (3 channels), sdf_eval, the nearest node, the upsample
    and the three constructors, bit for bit or within 1e-6; points beyond
    the cube and on its faces included."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    pts[:6, 0], pts[6:12, 1] = 0.0, 1.0
    vals = rng.normal(size=(5, 6, 7, 3)).astype(np.float32)
    J, S, P = jax.jit, jnp.asarray(sdf_np), jnp.asarray(pts)
    _close(tg.grid_sample(t_(vals), t_(pts)), J(jg.grid_sample)(jnp.asarray(vals), P), 0, 1e-6)
    _close(tg.sdf_eval(t_(sdf_np), t_(pts)), J(jg.sdf_eval)(S, P), 0, 1e-6)
    _close(tg.sdf_eval_nearest(t_(sdf_np), t_(pts)), J(jg.sdf_eval_nearest)(S, P), 0, 0)
    _close(tg.upsample_grid(t_(sdf_np), 2 * RES - 1), J(jg.upsample_grid, static_argnums=1)(S, 2 * RES - 1), 0, 1e-6)
    for t_grid, j_grid in ((tg.sphere_sdf_grid(9, 0.27), J(lambda: jg.sphere_sdf_grid(9, 0.27))()),
                           (tg.box_sdf_grid(9, 0.2, (0.4, 0.5, 0.6)), J(lambda: jg.box_sdf_grid(9, 0.2, (0.4, 0.5, 0.6)))()),
                           (tg.composite_sdf_grid(RES), sdf_np)):
        _close(t_grid, j_grid, 0, 1e-6)


def test_sdf_gradient_matches_jax_grad(sdf_np):
    """The closed form against jax.grad of the sample's sum (within 1e-5 of
    the largest component), also on the faces (jnp.clip's half derivative)
    and beyond; and the gradients of a loss on the normals with respect to
    the SDF values and the points, through the closed form's own
    derivative (relative 1e-4)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.05, 1.05, (400, 3)).astype(np.float32)
    pts[:8, 2], pts[8:16, 0] = 1.0, 0.0
    ref = np.asarray(jax.jit(jg.sdf_gradient)(jnp.asarray(sdf_np), jnp.asarray(pts)))
    _close(tg.sdf_gradient(t_(sdf_np), t_(pts)), ref, 0, 1e-5 * np.abs(ref).max())
    w = rng.normal(size=(400, 3)).astype(np.float32)
    gs, gp = jax.jit(jax.grad(lambda s, p: jnp.sum(jg.sdf_normal(s, p) * w), argnums=(0, 1)))(
        jnp.asarray(sdf_np), jnp.asarray(pts))
    s, p = t_(sdf_np).requires_grad_(), t_(pts).requires_grad_()
    (tg.sdf_normal(s, p) * t_(w)).sum().backward()
    _close(s.grad, gs, 0, 1e-4 * np.abs(np.asarray(gs)).max())
    _close(p.grad, gp, 0, 1e-4 * np.abs(np.asarray(gp)).max())


def test_sdf_normal_backward_is_finite_on_a_flat_grid():
    """A flat grid has a zero gradient: the normal is 0 and its backward
    finite, and equal to JAX's (relative 1e-4; the cotangent scales by
    rsqrt(eps) = 1e6 there)."""
    s = torch.zeros((9, 9, 9, 1), requires_grad=True)
    p = torch.rand((32, 3), generator=torch.Generator().manual_seed(0)).requires_grad_()
    n = tg.sdf_normal(s, p)
    n.sum().backward()
    assert bool((n == 0).all()) and bool(torch.isfinite(s.grad).all()) and bool(torch.isfinite(p.grad).all())
    gj = jax.jit(jax.grad(lambda s_: jnp.sum(jg.sdf_normal(s_, jnp.asarray(p.detach().numpy())))))(
        jnp.zeros((9, 9, 9, 1)))
    _close(s.grad, gj, 1e-4, 0)


# ---- tracers


def test_tracers_match_jax(sdf_np):
    """t, hit and t_closest of both tracers, with and without the coarse
    march and a t_start; t within 2e-4 on rays that hit on both sides."""
    o, d = pinhole_rays(12)
    for cfg in (dict(TRACE), dict(TRACE, coarse_steps=0)):
        jc, tc = jst.SphereTraceConfig(**cfg), tst.SphereTraceConfig(**cfg)
        jt, jh, jcl = jax.jit(jst.sphere_trace_with_closest, static_argnums=3)(
            jnp.asarray(sdf_np), jnp.asarray(o), jnp.asarray(d), jc)
        tt, th, tcl = tst.sphere_trace_with_closest(t_(sdf_np), t_(o), t_(d), tc)
        both = np.asarray(jh) & th.numpy()
        assert (th.numpy() != np.asarray(jh)).mean() <= FLIP_SHARE and both.sum() > 20
        _close(tt, jt, 0, 2e-4, both)
        _close(tcl, jcl, 0, 2e-4, both)
        t_start = np.linspace(0.0, 0.5, o.shape[0]).astype(np.float32)
        jt2, jh2 = jax.jit(jst.sphere_trace, static_argnums=3)(jnp.asarray(sdf_np), jnp.asarray(o), jnp.asarray(d),
                                                               jc, jnp.asarray(t_start))
        tt2, th2 = tst.sphere_trace(t_(sdf_np), t_(o), t_(d), tc, t_(t_start))
        both2 = np.asarray(jh2) & th2.numpy()
        assert (th2.numpy() != np.asarray(jh2)).mean() <= FLIP_SHARE
        _close(tt2, jt2, 0, 2e-4, both2)


def test_differentiable_hit_t_gradients_match_jax(sdf_np):
    """The implicit derivative with respect to the SDF values, o and d on
    rays that hit on both sides (relative 1e-4 of the largest component);
    the value is t* itself."""
    o, d = pinhole_rays(10)
    jc, tc = jst.SphereTraceConfig(**TRACE), tst.SphereTraceConfig(**TRACE)
    _, jh = jax.jit(jst.sphere_trace, static_argnums=3)(jnp.asarray(sdf_np), jnp.asarray(o), jnp.asarray(d), jc)
    t_star, th = tst.sphere_trace(t_(sdf_np), t_(o), t_(d), tc)
    w = (np.asarray(jh) & th.numpy()).astype(np.float32) * np.linspace(0.5, 1.5, o.shape[0]).astype(np.float32)

    def jl(s, o_, d_):
        t, _ = jst.sphere_trace(s, o_, d_, jc)
        return jnp.sum(jst.differentiable_hit_t(s, o_, d_, t) * w)

    ref = jax.jit(jax.grad(jl, argnums=(0, 1, 2)))(jnp.asarray(sdf_np), jnp.asarray(o), jnp.asarray(d))
    args = [t_(x).requires_grad_() for x in (sdf_np, o, d)]
    t = tst.differentiable_hit_t(*args, t_star)
    assert torch.equal(t.detach(), t_star)
    (t * t_(w)).sum().backward()
    for a, r in zip(args, ref):
        _close(a.grad, r, 0, 1e-4 * np.abs(np.asarray(r)).max())


def test_hit_t_is_nan_where_the_reference_clamp_is_zero():
    """The reference's differentiable_hit_t clamps a small denominator
    <grad f, d> to sign(denom) eps + eps, which is 0 for a small negative
    one: its t is then 0 / 0 = NaN (here on misses; on the card a grazing
    hit made a pixel, and the takeover's loss, NaN). The port moves such a
    denominator to -2 eps: on those rays its t is t* and its derivatives
    are finite; on every other ray it equals the reference's."""
    js, ts = scene_pair("envmap")
    o, d = pinhole_rays(span=(0.15, 0.85))
    tt, _ = tst.sphere_trace(ts.sdf, t_(o), t_(d), tst.SphereTraceConfig(**TRACE))
    # the reference's formula at the port's t*
    j_t = np.asarray(jst.differentiable_hit_t(js.sdf, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tt.numpy())))
    j_nan = np.isnan(j_t)
    sdf = ts.sdf.clone().requires_grad_()
    t = tst.differentiable_hit_t(sdf, t_(o), t_(d), tt)
    assert j_nan.any() and torch.equal(t.detach(), tt)
    _close(t, j_t, 0, 0, ~j_nan)
    t.sum().backward()
    assert bool(torch.isfinite(sdf.grad).all())


@pytest.mark.parametrize("side", [-1.0, 0.0, 1.0])
def test_hit_t_at_a_grazing_hit(side):
    """A hit on the plane z = 0.5 by a ray along it, <grad f, d> = side x
    1e-7 (under eps = 1e-6): t is t*, and dt/df at the hit's cell is
    finite, of the sign the denominator's clamp gives (-2 eps for a small
    negative one, eps for 0, 2 eps for a small positive one)."""
    res = 9
    z = torch.linspace(0.0, 1.0, res)
    sdf = (z - 0.5).expand(res, res, res).contiguous().requires_grad_()
    d = torch.tensor([[1.0, 0.0, side * 1e-7]])
    o = torch.tensor([[0.1, 0.5, 0.5]])
    t_star = torch.tensor([0.4])
    t = tst.differentiable_hit_t(sdf, o, d, t_star)
    assert torch.equal(t.detach(), t_star)
    t.sum().backward()
    g = sdf.grad
    assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    # dt = -df / denom, and df/d(sdf) sums to 1 over the cell's corners
    want = -1.0 / ({-1.0: -2e-6, 0.0: 1e-6, 1.0: 2e-6}[side])
    assert math.isclose(float(g.sum()), want, rel_tol=1e-3)


# ---- BSDFs and emitters


def test_bsdfs_match_jax():
    """Eval, pdf and sample of the diffuse and principled BSDFs, on JAX's
    draws: diffuse within relative 1e-5, the principled one within 1e-4
    (its GGX lobe at roughness 0.02 magnifies f32 rounding)."""
    rng = np.random.default_rng(6)
    n = rng.normal(size=(200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wi, wo = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in rng.normal(size=(2, 200, 3)).astype(np.float32))
    albedo = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    rough = rng.uniform(0, 1, (200, 1)).astype(np.float32)
    J, T, jit = jnp.asarray, t_, jax.jit
    _close(tb.diffuse_eval(T(albedo), T(n), T(wo)), jit(jb.diffuse_eval)(J(albedo), J(n), J(wo)), 1e-5, 1e-7)
    _close(tb.diffuse_pdf(T(n), T(wo)), jit(jb.diffuse_pdf)(J(n), J(wo)), 1e-5, 1e-7)
    _close(tb.principled_eval(T(albedo), T(rough), T(n), T(wi), T(wo)),
           jit(jb.principled_eval)(J(albedo), J(rough), J(n), J(wi), J(wo)), 1e-4, 1e-6)
    _close(tb.principled_pdf(T(rough), T(n), T(wi), T(wo)), jit(jb.principled_pdf)(J(rough), J(n), J(wi), J(wo)),
           1e-4, 1e-6)
    key = jax.random.PRNGKey(7)
    jd, jp = jit(jb.cosine_sample_hemisphere)(key, J(n))
    td, tp = tb.cosine_sample_hemisphere(T(n), t_(jax.random.uniform(key, (200, 2))))
    _close(td, jd, 0, 2e-6)
    _close(tp, jp, 1e-5, 1e-7)
    jd, jp = jb.principled_sample(key, J(rough), J(n), J(wi))  # eager: XLA's fused GGX sample rounds 7e-5 apart
    k1, k2, k3 = jax.random.split(key, 3)
    td, tp = tb.principled_sample(T(rough), T(n), T(wi), t_(jax.random.uniform(k1, (200, 2))),
                                  t_(jax.random.uniform(k2, (200, 2))), t_(jax.random.uniform(k3, (200,))))
    _close(td, jd, 0, 2e-5)
    _close(tp, jp, 1e-4, 1e-6)


def test_envmap_matches_jax():
    """The equirect maps, and the envmap's tables, eval, pdf and sample on
    JAX's draws (searchsorted's left side, the column a count of CDF
    entries below u)."""
    img = _envmap_image()
    jenv, tenv = jax.jit(je.EnvmapEmitter.create)(jnp.asarray(img)), te.EnvmapEmitter.create(t_(img))
    for k in ("row_cdf", "cond_cdf"):
        _close(getattr(tenv, k), getattr(jenv, k), 1e-6, 1e-7)
    rng = np.random.default_rng(8)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(te.dir_to_equirect(t_(d)), jax.jit(je.dir_to_equirect)(jnp.asarray(d)), 0, 1e-6)
    uv = rng.uniform(0, 1, (300, 2)).astype(np.float32)
    _close(te.equirect_to_dir(t_(uv)), jax.jit(je.equirect_to_dir)(jnp.asarray(uv)), 0, 1e-6)
    _close(tenv.eval(t_(d)), jax.jit(lambda e, x: e.eval(x))(jenv, jnp.asarray(d)), 1e-5, 1e-6)
    _close(tenv.pdf(t_(d)), jax.jit(lambda e, x: e.pdf(x))(jenv, jnp.asarray(d)), 1e-5, 1e-6)
    key = jax.random.PRNGKey(9)
    jd, jp = jax.jit(lambda e, k: e.sample(k, (300,)))(jenv, key)
    k1, k2, k3 = jax.random.split(key, 3)
    u = (jax.random.uniform(k1, (300,)), jax.random.uniform(k2, (300,)), jax.random.uniform(k3, (300, 2)))
    td, tp = tenv.sample((300,), uniforms=tuple(t_(x) for x in u))
    _close(td, jd, 0, 2e-6)
    _close(tp, jp, 1e-5, 1e-6)


def test_sensors_match_jax():
    """Camera rays in render space (jittered, scaled, turntable-free) and
    the spherical fan."""
    c2w = np.array([[[1, 0, 0, 0.1], [0, 1, 0, 0.2], [0, 0, 1, 2.0]]], np.float32)
    f, c = np.full(1, 9.0, np.float32), np.full(1, 4.0, np.float32)
    jc = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(f), fy=jnp.asarray(f), cx=jnp.asarray(c),
                  cy=jnp.asarray(c), width=8, height=8)
    tc = Cameras(camera_to_worlds=t_(c2w), fx=t_(f), fy=t_(f), cx=t_(c), cy=t_(c), width=8, height=8)
    key = jax.random.PRNGKey(10)
    jo, jd = jax.jit(lambda k: jsen.camera_rays_in_render_space(jc, jnp.int32(0), 8, 8, 1.5, key=k))(key)
    to, td = tsen.camera_rays_in_render_space(tc, 0, 8, 8, 1.5, jitter=t_(jax.random.uniform(key, (64, 2))))
    _close(to, jo, 0, 1e-6)
    _close(td, jd, 0, 1e-6)
    jo, jd = jax.jit(jsen.spherical_rays, static_argnums=(1, 2))(jnp.asarray([0.4, 0.5, 0.6]), 4, 8)
    to, td = tsen.spherical_rays(t_([0.4, 0.5, 0.6]), 4, 8)
    _close(to, jo, 0, 0)
    _close(td, jd, 0, 1e-6)


def test_spp_schedule_matches_jax():
    for total, per in ((32, 8), (13, 4), (7, 8), (0, 4)):
        for p2 in (True, False):
            assert tspp.divide_spp(total, per, p2) == jspp.divide_spp(total, per, p2)
    rng = np.random.default_rng(11)
    rgb, nrm, dep = (rng.uniform(0, 1, (8, 8, c)).astype(np.float32) for c in (3, 3, 1))
    _close(tspp.bilateral_denoise(t_(rgb), t_(nrm), t_(dep)),
           jax.jit(jspp.bilateral_denoise)(jnp.asarray(rgb), jnp.asarray(nrm), jnp.asarray(dep)), 1e-5, 1e-6)
    assert tspp.no_denoise(t_(rgb)).shape == (8, 8, 3)
