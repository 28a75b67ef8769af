"""The port's integrator against the JAX package: render_direct in both
MIS modes with the warp and the soft silhouette, under an envmap and under
vMF guiding with an emitter function (outputs and the gradient with
respect to the SDF and the albedo), render_spp's regrouping and
checkpointing, the curvature and normal-depth modes, draws from a
generator, and the rows of render_direct's emitter calls. JAX's draws are handed to the port (test_torch_renderer.py's
`j_direct_draws`); where f32 rounding in another order flips a grazing
ray's hit, the share of flipped rays is held, then the rest tightly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.renderer import integrator as ji
from nerf_emitter_tpu.renderer import sphere_trace as jst
from nerf_emitter_tpu_torch.renderer import integrator as ti
from nerf_emitter_tpu_torch.renderer import sphere_trace as tst
from nerf_emitter_tpu_torch.utils import profiler
from test_torch_renderer import (FLIP_SHARE, TRACE, _close, emitter_fns, j_direct_draws, j_spp_draws,
                                 pinhole_rays, scene_pair, t_)

torch.set_num_threads(1)


def _direct_case(mis, reparam, emitter, seed):
    """Configs for both packages: the one-sample envmap case warps the
    secondary rays too (the others do not), and the one-sample soft vMF
    case hides the emitter behind the object."""
    js, ts = scene_pair(emitter)
    js = js.replace(hide_emitters=(mis, reparam, emitter) == ("one_sample", "soft", "vmf"))
    ts = ts.replace(hide_emitters=js.hide_emitters)
    o, d = pinhole_rays()
    cfg = dict(mis_mode=mis, reparam=reparam, warp_secondary=(mis, emitter) == ("one_sample", "envmap"))
    jcfg = ji.RenderConfig(trace=jst.SphereTraceConfig(**TRACE), **cfg)
    tcfg = ti.RenderConfig(trace=tst.SphereTraceConfig(**TRACE), **cfg)
    j_fn, t_fn = emitter_fns() if emitter == "vmf" else (None, None)
    key = jax.random.PRNGKey(seed)
    return js, ts, o, d, jcfg, tcfg, j_fn, t_fn, key, j_direct_draws(key, js, o.shape[0])


_OUT_KEYS = ("rgb", "alpha", "soft_mask", "depth", "normal", "hit")


@pytest.mark.parametrize("emitter", ["envmap", "vmf"])
@pytest.mark.parametrize("reparam", ["warp", "soft"])
@pytest.mark.parametrize("mis", ["both", "one_sample"])
def test_render_direct_matches_jax(mis, reparam, emitter):
    """Every output of render_direct on JAX's draws, and the gradient of a
    loss on rgb and alpha with respect to the SDF values and the albedo
    grid: outputs within 1e-4 (relative) on rays whose hits agree, and at
    most FLIP_SHARE of the rays flipped; the gradients (the flipped rays
    left out of the loss on both sides) by relative L2 (2e-3) and cosine."""
    js, ts, o, d, jcfg, tcfg, j_fn, t_fn, key, draws = _direct_case(mis, reparam, emitter, 12)
    sdf, albedo = ts.sdf.clone().requires_grad_(), ts.albedo.clone().requires_grad_()
    tout = ti.render_direct(ts.replace(sdf=sdf, albedo=albedo), t_(o), t_(d), draws=draws, emitter_fn=t_fn,
                            config=tcfg)

    def jrender(sdf_, albedo_):
        out = ji.render_direct(js.replace(sdf=sdf_, albedo=albedo_), jnp.asarray(o), jnp.asarray(d), key,
                               emitter_fn=j_fn, config=jcfg)
        return tuple(out[k] for k in _OUT_KEYS)

    # one JAX evaluation gives the outputs and, through its vjp, the gradient
    jvals, vjp = jax.vjp(jrender, js.sdf, js.albedo, has_aux=False)
    jout = dict(zip(_OUT_KEYS, jvals))
    same = np.asarray(jout["hit"]) == tout["hit"].numpy()
    assert (~same).mean() <= FLIP_SHARE and np.asarray(jout["hit"]).sum() > 10
    for k in _OUT_KEYS[:-1]:
        _close(tout[k], jout[k], 1e-4, 1e-5, same)
    w = np.random.default_rng(13).uniform(0.5, 1.5, (o.shape[0], 3)).astype(np.float32) * same[:, None]
    cot = tuple(jnp.zeros_like(v) for v in jvals)
    cot = (jnp.asarray(w), jnp.asarray(w[:, 0])) + cot[2:5] + (np.zeros(jvals[5].shape, jax.dtypes.float0),)
    gj = vjp(cot)
    ((tout["rgb"] * t_(w)).sum() + (tout["alpha"] * t_(w[:, 0])).sum()).backward()
    for a, b in ((sdf.grad, gj[0]), (albedo.grad, gj[1])):
        a, b = a.double().flatten(), torch.from_numpy(np.asarray(b, np.float64)).flatten()
        assert float(b.norm()) > 0
        assert float((a - b).norm() / b.norm()) < 2e-3 and float(a @ b / (a.norm() * b.norm())) > 0.9999


@pytest.mark.parametrize("hide", [False, True])
@pytest.mark.parametrize("mis", ["one_sample", "both"])
def test_render_direct_asks_the_emitter_once(mis, hide, monkeypatch):
    """With the emitter visible, render_direct makes one emitter call of N
    rows (one_sample) or 2N (both): row i asks for the primary ray where it
    escapes and for the surface's first secondary ray where it hits, the
    second strategy's rays follow, and the escaped pixels read the answer
    of their own row; emitter.merged_rays counts the escaped rows. With the
    emitter hidden, each secondary ray has its own call of N rows, as the
    visibility traces saw them, and escaped pixels are black."""
    _, ts = scene_pair("vmf")
    ts = ts.replace(hide_emitters=hide)
    o, d = (t_(a) for a in pinhole_rays(12, span=(0.15, 0.85)))
    n = o.shape[0]
    calls, secondary = [], []
    real_trace = ti.sphere_trace

    def sphere_trace(sdf, x_from, dirs, config):
        secondary.append((x_from.detach().clone(), dirs.detach().clone()))
        return real_trace(sdf, x_from, dirs, config)

    def emitter(x, dd):
        calls.append((x.detach().clone(), dd.detach().clone()))
        return 1.0 + dd.abs() + 0.1 * x

    monkeypatch.setattr(ti, "sphere_trace", sphere_trace)
    cfg = ti.RenderConfig(trace=tst.SphereTraceConfig(**TRACE), mis_mode=mis, reparam="soft")
    profiler.reset()
    profiler.enable()
    try:
        out = ti.render_direct(ts, o, d, torch.Generator().manual_seed(2), emitter_fn=emitter, config=cfg)
        counters = profiler.counters()
    finally:
        profiler.disable()
        profiler.reset()
    hit = out["hit"]
    assert 0 < int(hit.sum()) < n and len(secondary) == (1 if mis == "one_sample" else 2)
    if hide:
        assert [c[0].shape[0] for c in calls] == [n] * len(secondary)
        for (x, dd), (x_s, d_s) in zip(calls, secondary):
            assert torch.equal(x, x_s) and torch.equal(dd, d_s)
        assert "emitter.merged_rays" not in counters
        assert torch.equal(out["rgb"][~hit], torch.zeros_like(out["rgb"][~hit]))
        return
    assert len(calls) == 1
    x, dd = calls[0]
    assert x.shape == dd.shape == (n * len(secondary), 3)
    esc = ~hit[:, None]
    assert torch.equal(x[:n], torch.where(esc, o, secondary[0][0]))
    assert torch.equal(dd[:n], torch.where(esc, d, secondary[0][1]))
    if mis == "both":
        assert torch.equal(x[n:], secondary[1][0]) and torch.equal(dd[n:], secondary[1][1])
    assert torch.equal(out["rgb"][~hit], emitter(o, d)[~hit])
    assert counters["emitter.merged_rays"] == int((~hit).sum())
    assert counters["emitter.rays"] == x.shape[0]


def test_render_spp_regroups_and_checkpoints():
    """render_spp at spp_per_batch 4 equals b = 1 on the same draws, and
    JAX's render_spp on its own; the checkpointed gradient equals the plain
    one to the bit."""
    js, ts = scene_pair("envmap")
    o, d = pinhole_rays()
    cfg = dict(mis_mode="one_sample", reparam="soft")
    jcfg = ji.RenderConfig(trace=jst.SphereTraceConfig(**TRACE), **cfg)
    tcfg = ti.RenderConfig(trace=tst.SphereTraceConfig(**TRACE), **cfg)
    key = jax.random.PRNGKey(14)
    draws = j_spp_draws(key, js, o.shape[0], 8)
    ref = ji.render_spp(js, jnp.asarray(o), jnp.asarray(d), key, 8, config=jcfg, spp_per_batch=4)
    one = ti.render_spp(ts, t_(o), t_(d), 8, draws=draws, config=tcfg, spp_per_batch=1)
    four = ti.render_spp(ts, t_(o), t_(d), 8, draws=draws, config=tcfg, spp_per_batch=4)
    same = np.asarray(ref["hit"]) == four["hit"].numpy()
    assert (~same).mean() <= FLIP_SHARE
    for k in ("rgb", "alpha", "soft_mask", "depth", "normal"):
        _close(four[k], one[k], 1e-6, 1e-7)
        _close(four[k], ref[k], 1e-4, 1e-5, same)

    def grads(remat):
        sdf, albedo = ts.sdf.clone().requires_grad_(), ts.albedo.clone().requires_grad_()
        out = ti.render_spp(ts.replace(sdf=sdf, albedo=albedo), t_(o), t_(d), 8, draws=draws, config=tcfg,
                            spp_per_batch=4, remat=remat)
        (out["rgb"].sum() + out["soft_mask"].sum()).backward()
        return sdf.grad, albedo.grad

    for a, b in zip(grads(True), grads(False)):
        assert torch.equal(a, b) and float(a.abs().sum()) > 0


def test_curvature_and_normal_depth_match_jax():
    js, ts = scene_pair("envmap")
    o, d = pinhole_rays(10)
    jcfg = ji.RenderConfig(trace=jst.SphereTraceConfig(**TRACE))
    tcfg = ti.RenderConfig(trace=tst.SphereTraceConfig(**TRACE))
    jc = ji.render_curvature(js, jnp.asarray(o), jnp.asarray(d), jcfg, curvature_epsilon=0.04)
    tc = ti.render_curvature(ts, t_(o), t_(d), tcfg, curvature_epsilon=0.04)
    jnd = ji.render_normal_depth(js, jnp.asarray(o), jnp.asarray(d), jcfg)
    tnd = ti.render_normal_depth(ts, t_(o), t_(d), tcfg)
    same = np.asarray(jnd["hit"]) == tnd["hit"].numpy()
    assert (~same).mean() <= FLIP_SHARE and same.sum() > 50
    _close(tc, jc, 1e-3, 1e-3, same)
    _close(tnd["normal"], jnd["normal"], 1e-4, 1e-5, same)
    _close(tnd["depth"], jnd["depth"], 1e-4, 1e-5, same)
    w = np.asarray(jnd["hit"], np.float32) * same
    gj = jax.grad(lambda s: jnp.sum(ji.render_curvature(js.replace(sdf=s), jnp.asarray(o), jnp.asarray(d), jcfg,
                                                        curvature_epsilon=0.04) * w))(js.sdf)
    s = ts.sdf.clone().requires_grad_()
    (ti.render_curvature(ts.replace(sdf=s), t_(o), t_(d), tcfg, curvature_epsilon=0.04) * t_(w)).sum().backward()
    _close(s.grad, gj, 0, 1e-3 * np.abs(np.asarray(gj)).max())


def test_render_draws_from_a_generator():
    """Without given draws the port draws from a generator: the same seed
    renders the same image, and the uniform-sphere fallback (no envmap,
    no guiding) is finite."""
    _, ts = scene_pair("envmap")
    o, d = pinhole_rays()
    cfg = ti.RenderConfig(trace=tst.SphereTraceConfig(**TRACE), reparam="soft")
    a = ti.render_spp(ts, t_(o), t_(d), 2, torch.Generator().manual_seed(0), config=cfg)["rgb"]
    b = ti.render_spp(ts, t_(o), t_(d), 2, torch.Generator().manual_seed(0), config=cfg)["rgb"]
    assert torch.equal(a, b)
    bare = ts.replace(envmap=None)
    _, t_fn = emitter_fns()
    out = ti.render_direct(bare, t_(o), t_(d), torch.Generator().manual_seed(1), emitter_fn=t_fn, config=cfg)
    assert bool(torch.isfinite(out["rgb"]).all()) and math.isfinite(float(out["rgb"].sum()))
