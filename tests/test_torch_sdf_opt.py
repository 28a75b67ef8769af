"""The port's SDF optimisation and takeover step against the JAX package:
the regularisers, redistancing and the Sobolev smoothing; Adam, the
Sobolev chain and uniform Adam against optax over 3 steps; the recipes
field by field; the clamps, the redistancing schedule and the upsample;
the GT resize against jax.image.resize; and one exact-mode and one
aggregate-mode (2 gradient bands) `make_sdf_train_step` step on JAX's
draws, their gradients and the scene after the update.

Adam at eps 1e-15 turns a roundoff-level gradient into a +-lr step with
the roundoff's sign, so the updated albedo is held only where both
packages' gradients agree within 1% of the largest one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_emitter_tpu.cameras.cameras import Cameras as JCameras
from nerf_emitter_tpu.fields import rotater as jrot
from nerf_emitter_tpu.pipelines import sdf_optimizer as jso
from nerf_emitter_tpu.renderer import integrator as ji
from nerf_emitter_tpu.renderer import optimize as jopt
from nerf_emitter_tpu.renderer import sphere_trace as jst
from nerf_emitter_tpu.renderer.grid3d import sphere_sdf_grid
from nerf_emitter_tpu_torch.cameras.cameras import Cameras
from nerf_emitter_tpu_torch.fields import rotater as trot
from nerf_emitter_tpu_torch.pipelines import sdf_optimizer as tso
from nerf_emitter_tpu_torch.renderer import integrator as ti
from nerf_emitter_tpu_torch.renderer.grid3d import upsample_grid
from nerf_emitter_tpu_torch.renderer import optimize as topt
from nerf_emitter_tpu_torch.renderer import sphere_trace as tst
from test_torch_renderer import TRACE, _close, emitter_fns, j_spp_draws, scene_pair, t_

torch.set_num_threads(1)

RECIPE = "diffuse-12-relativel1-hqq"


def test_regularisers_and_redistance_match_jax():
    """laplacian_reg and eikonal_residual (relative 1e-5), the Sobolev
    smoothing of a 1- and a 3-channel grid (1e-5), and redistance of a
    squashed sphere and of the composite object (1e-5 absolute; 100
    Jacobi iterations, the periodic band)."""
    rng = np.random.default_rng(0)
    squashed = np.asarray(sphere_sdf_grid(17, radius=0.3)) / 3.0
    _, ts = scene_pair("envmap")
    for g in (squashed, ts.sdf.numpy()):
        _close(topt.laplacian_reg(t_(g)), jopt.laplacian_reg(jnp.asarray(g)), 1e-5, 0)
        _close(topt.eikonal_residual(t_(g)), jopt.eikonal_residual(jnp.asarray(g)), 1e-5, 0)
        _close(topt.redistance(t_(g)), jopt.redistance(jnp.asarray(g)), 0, 1e-5)
    for c in (1, 3):
        g = rng.normal(size=(9, 9, 9, c)).astype(np.float32)
        _close(topt.smooth_gradient(t_(g), 2.0), jopt.smooth_gradient(jnp.asarray(g), 2.0), 1e-5, 1e-6)
    assert float(topt.eikonal_residual(topt.redistance(t_(squashed)))) < 0.5 * float(
        topt.eikonal_residual(t_(squashed)))


def test_redistance_at_127_leaves_the_far_field_unreached():
    """redistance's 100 Jacobi sweeps move the front one node a sweep along
    the axes, so from a 127^3 grid on (the recipes' first upsample) the far
    corners stay at the sqrt(3) cap, and the field has a cliff where the
    front stopped. Both packages agree (1e-4 absolute) on the sphere of
    radius 0.25 upsampled from 64^3 to 127^3: 2.8% of its nodes stay capped
    (none at 65^3), and the front is exact near the surface (1e-2 within
    0.1)."""
    up = upsample_grid(t_(sphere_sdf_grid(64, radius=0.25)), 127)
    ref = np.asarray(jopt.redistance(jnp.asarray(up.numpy())))
    got = topt.redistance(up)
    _close(got, ref, 0, 1e-4)
    for capped in (float((got >= 1.73).float().mean()), float((ref >= 1.73).mean())):
        assert abs(capped - 0.0279) < 1e-3
    near = up.abs() < 0.1
    assert float((got - up).abs()[near].max()) < 1e-2


def test_gradient_transforms_match_optax_over_three_steps():
    """Adam (eps 1e-15), the Sobolev chain with uniform Adam, and uniform
    Adam alone, each against its optax form over 3 steps of the same
    gradients (2e-5 of each update's largest component: the Sobolev
    chain's 16 Jacobi sweeps sum in another order)."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(9, 9, 9, 1)).astype(np.float32)
    grads = [rng.normal(size=p.shape).astype(np.float32) * s for s in (1.0, 0.3, 2.0)]
    pairs = [(topt.adam(3e-3, eps=1e-15), optax.adam(3e-3, eps=1e-15)),
             (topt.chain(topt.sobolev_preconditioner(2.0), topt.uniform_adam(3e-3)),
              optax.chain(jopt.sobolev_preconditioner(2.0), jopt.uniform_adam(3e-3))),
             (topt.uniform_adam(1e-2), jopt.uniform_adam(1e-2))]
    for t_tx, j_tx in pairs:
        ts_, js_ = t_tx.init(t_(p)), j_tx.init(jnp.asarray(p))
        for g in grads:
            tu, ts_ = t_tx.update(t_(g), ts_)
            ju, js_ = j_tx.update(jnp.asarray(g), js_)
            _close(tu, ju, 0, 2e-5 * np.abs(np.asarray(ju)).max())


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_recipes_match_jax():
    """Every recipe, and each of its variables, field by field."""
    assert sorted(topt.OPT_CONFIGS) == sorted(jopt.OPT_CONFIGS)
    for name in jopt.OPT_CONFIGS:
        t_cfg, j_cfg = topt.get_opt_config(name), jopt.get_opt_config(name)
        tf, jf = _fields(t_cfg), _fields(j_cfg)
        tv, jv = tf.pop("variables"), jf.pop("variables")
        assert tf == jf
        assert [_fields(v) for v in tv] == [_fields(v) for v in jv]
    with pytest.raises(KeyError):
        topt.get_opt_config("no-such-recipe")


def test_validate_params_and_upsample_match_jax():
    """validate_params at a clamping step and at a redistancing step,
    maybe_upsample at the recipe's first upsample step (9^3 -> 17^3), and
    post_step_host: the upsample restarts the optimiser state and the
    running means."""
    js, ts = scene_pair("envmap", res=9)
    js = js.replace(albedo=js.albedo * 2.0 - 0.3)
    ts = ts.replace(albedo=ts.albedo * 2.0 - 0.3)
    t_cfg, j_cfg = topt.get_opt_config(RECIPE), jopt.get_opt_config(RECIPE)
    for step in (1, 5):
        a, b = topt.validate_params(ts, t_cfg, step), jopt.validate_params(js, j_cfg, step)
        for k in ("sdf", "albedo", "roughness"):
            _close(getattr(a, k), getattr(b, k), 0, 1e-5)
    a, b = topt.maybe_upsample(ts, t_cfg, 64), jopt.maybe_upsample(js, j_cfg, 64)
    assert a.sdf.shape == (17, 17, 17, 1)
    _close(a.sdf, b.sdf, 0, 1e-6)
    assert topt.maybe_upsample(ts, t_cfg, 63).sdf.shape == ts.sdf.shape
    tx = tso.build_sdf_optimizer(t_cfg)
    state = tso.SdfOptState(step=64, scene=ts, opt_state=tx.init(ts), mean_params=tso.init_mean_params(ts),
                            mean_count=7)
    out = tso.post_step_host(state, t_cfg, tx)
    assert out.scene.sdf.shape == (17, 17, 17, 1) and out.mean_count == 0
    assert out.opt_state["sdf"][1]["mu"].shape == (17, 17, 17, 1) and out.mean_params["sdf"].shape[0] == 17
    g = {"sdf": torch.full((9, 9, 9, 1), float("nan")), "albedo": None}
    clean = topt.validate_gradients(g)
    assert bool((clean["sdf"] == 0).all()) and clean["albedo"] is None


def test_resize_matches_jax_image_resize():
    """The GT resize against jax.image.resize's "linear" (antialiased when
    it shrinks): 32 -> 8, 20 -> 8, 8 -> 16 and 1 channel (1e-5)."""
    rng = np.random.default_rng(2)
    for (h, w), (nh, nw), c in (((32, 32), (8, 8), 3), ((20, 20), (8, 8), 3), ((8, 8), (16, 16), 3),
                                ((32, 32), (8, 8), 1)):
        x = rng.uniform(0, 2, size=(h, w, c)).astype(np.float32)
        _close(tso.resize_image(t_(x), nh, nw), jax.image.resize(jnp.asarray(x), (nh, nw, c), "linear"), 0, 1e-5)


# ---- the train step


def _cameras(n=2, size=16):
    """n cameras on a ring at 16^2 pixels, looking at the unit cube's centre
    (world [-1, 1]^3)."""
    c2ws = []
    for i in range(n):
        th = 2 * np.pi * i / n + 0.3
        eye = 1.6 * np.array([np.cos(th), 0.35, np.sin(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        c2ws.append(np.stack([right, np.cross(right, fwd), -fwd, eye], axis=1))
    c2w = np.stack(c2ws).astype(np.float32)
    f, c = np.full(n, 20.0, np.float32), np.full(n, size / 2, np.float32)
    jc = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(f), fy=jnp.asarray(f), cx=jnp.asarray(c),
                  cy=jnp.asarray(c), width=size, height=size)
    tc = Cameras(camera_to_worlds=t_(c2w), fx=t_(f), fy=t_(f), cx=t_(c), cy=t_(c), width=size, height=size)
    return jc, tc


class _Recorder:
    """Wraps the port's optimiser: its state also keeps the last gradients."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, scene):
        return (self.tx.init(scene), None)

    def update(self, grads, state):
        updates, inner = self.tx.update(grads, state[0])
        return updates, (inner, grads)


def _j_recorder(tx):
    """The same wrapper around an optax transformation."""
    return optax.GradientTransformation(lambda p: (tx.init(p), p),
                                        lambda g, s, p=None: (tx.update(g, s[0], p)[0], (tx.update(g, s[0], p)[1], g)))


def _j_step_draws(step, key, jscene, b):
    """The draws of JAX's step from `key` for b images, as ImageDraws."""
    t = step.takeover
    hw, band_rays = t.image_height * t.image_width, step.band_h * t.image_width
    out = []
    for k in jax.random.split(key, b):
        if not step.aggregate:
            k_render, k_curv = jax.random.split(k)
            k_jitter, k_spp = jax.random.split(k_render)
            out.append(tso.ImageDraws(t_(jax.random.uniform(k_jitter, (hw, 2))), [],
                                      [j_spp_draws(k_spp, jscene, hw, t.spp)],
                                      [t_(jax.random.uniform(k_curv, (hw, 2)))]))
            continue
        k_jitter, k_spp = jax.random.split(k)
        fold = lambda i, j: jax.random.fold_in(jax.random.fold_in(k_spp, i), j)  # noqa: E731
        out.append(tso.ImageDraws(
            t_(jax.random.uniform(k_jitter, (hw, 2))),
            [j_spp_draws(fold(0, ci), jscene, hw, c) for ci, c in enumerate(step.chunks)],
            [j_spp_draws(fold(1, bi), jscene, band_rays, t.spp_attached) for bi in range(step.n_grad_bands)],
            [t_(jax.random.uniform(fold(2, bi), (hw, 2))) for bi in range(step.n_grad_bands)]))
    return out


@pytest.mark.parametrize("mode", ["exact", "aggregate"])
def test_train_step_matches_jax(mode, monkeypatch):
    """One step of make_sdf_train_step on a 9^3 scene with vMF guiding and a
    per-camera emitter function, 2 images of 16^2 resized to 8^2 renders,
    the recipe diffuse-12-relativel1-hqq, the pipeline's render settings
    (one-sample MIS, soft silhouette); exact: spp 2 in slices of 2, a
    turntable (4 rotations, the cameras at rotations 1 and 3); aggregate:
    spp 2, 1 attached, in 2 bands (a band budget of 32), with occlusion
    layers composited (given at 16^2, resized); exact mode also tracks
    the running means and swaps them in. On
    JAX's draws: the metrics (relative 1e-4), the gradients (relative L2
    1e-3, cosine 0.99999), and the scene after the update: the sdf (its
    Sobolev-smoothed uniform-Adam step, 1e-5 of the step) and the albedo
    where its gradient is above 1% of the largest and both agree within
    1% of it (90% of those voxels must).

    In aggregate mode the curvature term is left out of the gradient on
    both sides (curvature_mult 0; its value is still held): JAX's jitted
    band gradient of render_curvature is off the exact derivative, see
    test_curvature_gradient_against_float64."""
    monkeypatch.setenv("NERF_EMITTER_GRAD_BAND_BUDGET", "32")
    js, ts = scene_pair("vmf", res=9)
    jc, tc = _cameras()
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.2, 1.5, size=(2, 16, 16, 3)).astype(np.float32)
    yy, xx = np.mgrid[:16, :16]
    mask = (((yy - 7.5) ** 2 + (xx - 7.5) ** 2) < 30.0).astype(np.float32)[None, :, :, None].repeat(2, 0)
    cam_idx = np.array([1, 0], np.int32)
    j_fn, t_fn = emitter_fns()
    render = dict(mis_mode="one_sample", reparam="soft", warp_secondary=False)
    j_rc = ji.RenderConfig(trace=jst.SphereTraceConfig(**TRACE), **render)
    t_rc = ti.RenderConfig(trace=tst.SphereTraceConfig(**TRACE), **render)
    take = dict(spp=2, spp_per_batch=2, image_height=8, image_width=8,
                spp_attached=1 if mode == "aggregate" else 0)
    j_cfg, t_cfg = jopt.get_opt_config(RECIPE), topt.get_opt_config(RECIPE)
    if mode == "aggregate":
        j_cfg = dataclasses.replace(j_cfg, curvature_mult=0.0)
        t_cfg = dataclasses.replace(t_cfg, curvature_mult=0.0)
    j_tx, t_tx = _j_recorder(jso.build_sdf_optimizer(j_cfg)), _Recorder(tso.build_sdf_optimizer(t_cfg))
    if mode == "exact":
        rot_ids = np.array([1, 3], np.int32)
        j_kw = dict(rotater=jrot.Rotater.from_axis_angle(4, center=jnp.zeros(3)), camera_rot_ids=jnp.asarray(rot_ids))
        t_kw = dict(rotater=trot.Rotater.from_axis_angle(4, center=torch.zeros(3)),
                    camera_rot_ids=torch.from_numpy(rot_ids).long())
        occ = ()
    else:
        j_kw = t_kw = dict(use_occlusion=True)
        occ = tuple(rng.uniform(0, 1, size=(2, 16, 16, c)).astype(np.float32) for c in (3, 1, 3))
    j_step = jso.make_sdf_train_step(j_cfg, jso.TakeoverConfig(**take), j_tx, render_config=j_rc,
                                     emitter_for_camera=lambda c, r: lambda x, d: j_fn(x, d) * (1.0 + 0.1 * c),
                                     **j_kw)
    t_step = tso.make_sdf_train_step(t_cfg, tso.TakeoverConfig(**take), t_tx, render_config=t_rc,
                                     emitter_for_camera=lambda c, r: lambda x, d: t_fn(x, d) * (1.0 + 0.1 * c),
                                     **t_kw)
    assert (t_step.aggregate, t_step.n_grad_bands, t_step.chunks) == (
        (True, 2, [1]) if mode == "aggregate" else (False, 1, []))
    key = jax.random.PRNGKey(4)
    draws = _j_step_draws(t_step, key, js, 2)
    # JAX's step donates its state: it gets a copy
    # exact mode also tracks the running means (from step 0)
    j_means = jso.init_mean_params(js) if mode == "exact" else None
    j_state = jax.tree.map(jnp.array, jso.SdfOptState(step=jnp.int32(0), scene=js, opt_state=j_tx.init(js),
                                                      mean_params=j_means))
    j_new, j_m = j_step(j_state, jc, jnp.asarray(cam_idx), jnp.asarray(gt), jnp.asarray(mask), key,
                        *([tuple(jnp.asarray(x) for x in occ)] if occ else []))
    t_state = tso.SdfOptState(step=0, scene=ts, opt_state=t_tx.init(ts),
                              mean_params=tso.init_mean_params(ts) if mode == "exact" else None)
    t_new, t_m = t_step(t_state, tc, torch.from_numpy(cam_idx).long(), t_(gt), t_(mask), draws=draws,
                        occ_layers=tuple(t_(x) for x in occ) if occ else None)
    assert t_new.step == 1 and t_m["estimator_aggregate"] == float(j_m["estimator_aggregate"])
    for k in ("loss", "view_loss", "mask_loss", "curvature", "laplacian", "gnorm_sdf", "gnorm_albedo"):
        _close(t_m[k], j_m[k], 1e-4, 1e-7)
    j_grads, t_grads = j_new.opt_state[1], t_new.opt_state[1]
    for k in ("sdf", "albedo"):
        a, b = t_grads[k].double().flatten(), torch.from_numpy(np.asarray(getattr(j_grads, k), np.float64)).flatten()
        assert float(b.norm()) > 0
        assert float((a - b).norm() / b.norm()) < 1e-3 and float(a @ b / (a.norm() * b.norm())) > 0.99999
    step_size = np.abs(np.asarray(j_new.scene.sdf) - np.asarray(js.sdf)).max()
    _close(t_new.scene.sdf, j_new.scene.sdf, 0, 1e-5 * step_size)
    ga, gb = t_grads["albedo"].numpy(), np.asarray(j_grads.albedo)
    big = np.abs(gb) > 1e-2 * np.abs(gb).max()
    sure = big & (np.abs(ga - gb) <= 1e-2 * np.abs(gb).max())
    assert sure.sum() >= 0.9 * big.sum() > 0
    _close(t_new.scene.albedo, j_new.scene.albedo, 0, 1e-6, sure)
    if mode == "exact":
        assert t_new.mean_count == int(j_new.mean_count) == 1
        swapped = tso.load_mean_parameters(t_new).scene
        _close(swapped.sdf, jso.load_mean_parameters(j_new).scene.sdf, 0, 1e-5 * step_size)
        assert torch.equal(t_new.mean_params["sdf"], t_new.scene.sdf)


def test_curvature_gradient_against_float64():
    """The curvature regulariser's gradient with respect to the SDF values
    (render_curvature's mean on a ring camera's 8^2 rays, epsilon 0.025):
    the port in f32 and JAX evaluated eagerly agree with the port in f64
    within 1e-4 (relative L2; measured 3.3e-5 for both). JAX's jitted gradient of the same function
    is reported, not held: on XLA's CPU backend it is far off the exact
    derivative (relative L2 1.79 here, 0.2 on other rays); the jitted
    gradient of `jnp.where(hit, jnp.abs(lap), 0)` differs from the eager
    one, that of `jnp.abs(lap) * hit` does not."""
    js, ts = scene_pair("vmf", res=9)
    jc, tc = _cameras()
    key = jax.random.PRNGKey(5)
    from nerf_emitter_tpu.renderer.sensors import camera_rays_in_render_space as j_rays
    from nerf_emitter_tpu_torch.renderer.sensors import camera_rays_in_render_space as t_rays

    o, d = j_rays(jc, jnp.int32(1), 16, 16, 1.0, key=key)
    j_rc, t_rc = ji.RenderConfig(trace=jst.SphereTraceConfig(**TRACE)), ti.RenderConfig(
        trace=tst.SphereTraceConfig(**TRACE))

    def jf(s):
        return jnp.mean(ji.render_curvature(js.replace(sdf=s), o, d, j_rc, curvature_epsilon=0.025))

    eager = np.asarray(jax.grad(jf)(js.sdf), np.float64).ravel()
    jitted = np.asarray(jax.jit(jax.grad(jf))(js.sdf), np.float64).ravel()
    to, td = t_rays(tc, 1, 16, 16, 1.0, jitter=t_(jax.random.uniform(key, (256, 2))))
    grads = {}
    for dt in (torch.float32, torch.float64):
        s = ts.sdf.to(dt).clone().requires_grad_()
        ti.render_curvature(ts.replace(sdf=s), to.to(dt), td.to(dt), t_rc, curvature_epsilon=0.025).mean().backward()
        grads[dt] = s.grad.double().numpy().ravel()
    exact = grads[torch.float64]
    rel = {k: float(np.linalg.norm(v - exact) / np.linalg.norm(exact))
           for k, v in (("port_f32", grads[torch.float32]), ("jax_eager", eager), ("jax_jit", jitted))}
    print("curvature gradient, relative L2 against the f64 port:", rel)
    assert rel["port_f32"] < 1e-4 and rel["jax_eager"] < 1e-4
