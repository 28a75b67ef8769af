"""The port's two-phase pipeline against the JAX package: the TSDF fusion
and its init, the occlusion layers, the envmap guiding strategies, the
pipeline's TSDF init from the same NeRF, the takeover's schedule
arithmetic, one takeover iteration from one state, and the slice as a
whole (sdf-nerfacto with the distilled cache, and sdf-gt-envmap) at
tests/test_pipeline.py's tiny size.

JAX's pipeline methods run on an instance built without its __init__ (the
attributes they read set by hand), so no JAX two-phase run is jitted."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.cameras import Cameras as JCameras
from nerf_emitter_tpu.data import occlusion as jocc
from nerf_emitter_tpu.data.datamanager import ImageDataset as JImageDataset
from nerf_emitter_tpu.engine import train_loop as JT
from nerf_emitter_tpu.guiding import path_guiding as jpg
from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.pipelines import nerf_emitter as jne
from nerf_emitter_tpu.pipelines import sdf_optimizer as jso
from nerf_emitter_tpu.pipelines import tsdf as jtsdf
from nerf_emitter_tpu.renderer import integrator as ji
from nerf_emitter_tpu.renderer import optimize as jopt
from nerf_emitter_tpu.renderer import sphere_trace as jst
from nerf_emitter_tpu.utils import exr as jexr
from nerf_emitter_tpu_torch.bridge import _first, _is_moments, load_flax_params, load_sdf_opt_state
from nerf_emitter_tpu_torch.cameras.cameras import Cameras
from nerf_emitter_tpu_torch.data import occlusion as tocc
from nerf_emitter_tpu_torch.data.datamanager import ImageDataset
from nerf_emitter_tpu_torch.engine import train_loop as TT
from nerf_emitter_tpu_torch.guiding import path_guiding as tpg
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.pipelines import nerf_emitter as tne
from nerf_emitter_tpu_torch.pipelines import sdf_optimizer as tso
from nerf_emitter_tpu_torch.pipelines import tsdf as ttsdf
from nerf_emitter_tpu_torch.renderer import integrator as ti
from nerf_emitter_tpu_torch.renderer import optimize as topt
from nerf_emitter_tpu_torch.renderer import sphere_trace as tst
from nerf_emitter_tpu_torch.utils import exr as texr
from test_torch_renderer import TRACE, _close, emitter_fns, scene_pair, t_
from test_torch_sdf_opt import _j_step_draws
from test_torch_hash import AABB
from test_torch_train import FREQ, freq_pair

torch.set_num_threads(1)

BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))


# ---- TSDF fusion


def _ring(n=6, size=20, radius=0.8, focal=18.0, seed=0):
    """n cameras on a ring around the origin, both packages' Cameras."""
    c2w = []
    for i in range(n):
        th = 2 * np.pi * i / n + 0.2
        eye = radius * np.array([np.cos(th), 0.3 + 0.1 * (i % 2), np.sin(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w.append(np.stack([right, np.cross(right, fwd), -fwd, eye], 1))
    c2w = np.stack(c2w).astype(np.float32)
    f, c = np.full(n, focal, np.float32), np.full(n, size / 2, np.float32)
    jc = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(f), fy=jnp.asarray(f), cx=jnp.asarray(c),
                  cy=jnp.asarray(c), width=size, height=size)
    tc = Cameras(camera_to_worlds=t_(c2w), fx=t_(f), fy=t_(f), cx=t_(c), cy=t_(c), width=size, height=size)
    return jc, tc


def _sphere_depth(cams: Cameras, r=0.2):
    """Distances along each pixel-centre ray to a sphere of radius r at the
    origin (1e3 for a miss), (n, H, W, 1), computed in float64."""
    c2w = cams.camera_to_worlds.double().numpy()
    n, h, w = c2w.shape[0], cams.height, cams.width
    yy, xx = np.mgrid[:h, :w] + 0.5
    out = np.full((n, h, w, 1), 1e3, np.float32)
    for b in range(n):
        f, c = float(cams.fx[b]), float(cams.cx[b])
        d = np.stack([(xx - c) / f, -(yy - c) / f, -np.ones_like(xx)], -1) @ c2w[b, :, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = c2w[b, :, 3]
        bq, cq = d @ o, o @ o - r * r
        disc = bq * bq - cq
        out[b, ..., 0] = np.where(disc > 0, -bq - np.sqrt(np.maximum(disc, 0.0)), 1e3)
    return out


def _fragile(cams: Cameras, depth, res, object_aabb, px=1e-3, dist=1e-5):
    """Voxels that two f32 implementations may fuse differently beyond
    rounding (float64): in some view that sees the voxel, a comparison
    within a hair of its threshold (the projection within `px` pixels of an
    image edge, as in u <= w - 1; the observed distance within `dist` of
    -truncation), or bilinear taps that straddle the silhouette (a 1e3
    miss beside a surface: the miss depth scales the tap weights' rounding
    a thousandfold); or the centre within `dist` of the object box's
    faces."""
    c2w = cams.camera_to_worlds.double().numpy()
    h, w = depth.shape[1:3]
    trunc = 4.0 / res
    xs = np.linspace(0.0, 1.0, res)
    vox = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3) * 2.0 - 1.0
    near = np.zeros(vox.shape[0], bool)
    for b in range(c2w.shape[0]):
        p = (vox - c2w[b, :, 3]) @ c2w[b, :, :3]
        z = -p[:, 2]
        zc = np.maximum(z, 1e-6)
        u = float(cams.fx[b]) * p[:, 0] / zc + float(cams.cx[b])
        v = -float(cams.fy[b]) * p[:, 1] / zc + float(cams.cy[b])
        ui, vi = np.clip(u, 0, w - 1), np.clip(v, 0, h - 1)
        u0, v0 = np.floor(ui).astype(int), np.floor(vi).astype(int)
        u1, v1 = np.minimum(u0 + 1, w - 1), np.minimum(v0 + 1, h - 1)
        fu, fv = ui - u0, vi - v0
        dm = depth[b, ..., 0].astype(np.float64)
        dd = (dm[v0, u0] * (1 - fu) * (1 - fv) + dm[v0, u1] * fu * (1 - fv) + dm[v1, u0] * (1 - fu) * fv
              + dm[v1, u1] * fu * fv)
        sdf_obs = dd * zc / np.maximum(np.linalg.norm(p, axis=-1), 1e-6) - z
        edge = np.min(np.abs(np.stack([u, u - (w - 1), v, v - (h - 1)])), axis=0) < px
        taps = np.stack([dm[v0, u0], dm[v0, u1], dm[v1, u0], dm[v1, u1]])
        straddle = (taps.max(0) >= 1e3) & (taps.min(0) < 1e3) & (sdf_obs > -trunc)
        near |= (z > 0) & (edge | straddle | (np.abs(sdf_obs + trunc) < dist))
    if object_aabb is not None:
        near |= np.any(np.abs(np.abs(vox) - np.asarray(object_aabb)[1]) < dist, axis=-1)
    return near.reshape(res, res, res, 1)


@pytest.mark.parametrize("boxed", [False, True], ids=["no_box", "object_box"])
def test_tsdf_fusion_matches_jax(boxed):
    """integrate_tsdf on 6 ring views (20^2) of an analytic sphere at 32^3,
    with and without the object box: every voxel within atol 1e-6 of JAX's
    except the fragile ones (`_fragile`: a comparison within a hair of its
    threshold, or depth taps straddling the silhouette), where both
    packages' f32 arithmetic may fuse differently; at most 8 of those may
    differ. Measured: 3 differ without the box (by up to 3.3e-4, each at a
    silhouette tap), none with it. tsdf_init_sdf (100 redistancing sweeps)
    within 1e-5 of JAX's with the box (measured 7.3e-6); without it, of
    JAX's redistancing of the port's fusion (a differing voxel moves the
    front far from it)."""
    jc, tc = _ring()
    depth = _sphere_depth(tc)
    box = BOX if boxed else None
    ref = np.asarray(jtsdf.integrate_tsdf(jc, jnp.asarray(depth), res=32,
                                          object_aabb=None if box is None else jnp.asarray(box)))
    got = ttsdf.integrate_tsdf(tc, t_(depth), res=32, object_aabb=box).numpy()
    assert got.shape == ref.shape == (32, 32, 32, 1)
    off = np.abs(got - ref) > 1e-6
    near = _fragile(tc, depth, 32, box)
    assert not (off & ~near).any(), np.argwhere(off & ~near)[:5]
    assert off.sum() <= 8 and (off.sum() == 0) == boxed, int(off.sum())
    assert 0.001 < float((ref < 0).mean()) < 0.2  # the fusion found an interior
    got_sdf = ttsdf.tsdf_init_sdf(tc, t_(depth), res=32, object_aabb=box).numpy()
    if boxed:
        ref_sdf = jtsdf.tsdf_init_sdf(jc, jnp.asarray(depth), res=32, object_aabb=jnp.asarray(box))
    else:
        # redistancing carries a differing voxel's value across the grid
        # (100 sweeps): the init is held on the port's own fusion
        ref_sdf = jopt.redistance(jnp.asarray(got), n_iters=100)
    _close(got_sdf, ref_sdf, 0, 1e-5)


# ---- occlusion layers and envmap guiding


def test_occlusion_layers_match_jax():
    """composite_with_occlusion on random layers (1e-6), and
    render_occlusion_layers of the tiny `freq` NeRF with the scene
    contraction (bridged weights, far 3) on 2 ring views at 8^2: the NEAR occluder rgb and alpha and the FAR2INF
    background at the JAX suite's bar for bf16 models (rtol 2e-2, atol
    1e-4)."""
    rng = np.random.default_rng(0)
    layers = [rng.uniform(0, 1, size=(3, 4, 4, c)).astype(np.float32) for c in (3, 1, 3)]
    rgb, mask = rng.uniform(0, 2, size=(4, 4, 3)).astype(np.float32), rng.uniform(0, 1, size=(4, 4, 1)).astype(
        np.float32)
    j_occ, t_occ = jocc.OcclusionData(*(jnp.asarray(x) for x in layers)), tocc.OcclusionData(*(t_(x) for x in layers))
    _close(tocc.composite_with_occlusion(t_(rgb), t_(mask), t_occ, 2),
           jocc.composite_with_occlusion(jnp.asarray(rgb), jnp.asarray(mask), j_occ, 2), 1e-6, 1e-6)

    # the scene contraction: with the fake one, FAR2INF's samples out to 1e6
    # reach the encoding's sines unbounded, where no two libraries agree
    jm = JModel(aabb=AABB, **FREQ, use_fake_contraction=False)
    jc, tc = _ring(n=2, size=8)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jc.generate_rays(jnp.zeros((4,), jnp.int32),
                                                                     jnp.zeros((4, 2), jnp.int32)))
    pm = load_flax_params(NerfactoModel(AABB, device="cpu", **FREQ, use_fake_contraction=False),
                          jax.tree.map(np.asarray, params))
    j_render = JT.make_render_fn(jm, JT.TrainConfig(far=3.0))
    ref = jocc.render_occlusion_layers(lambda p, c, i, aabb_box=None: j_render(p, c, i, 8, 8, aabb_box=aabb_box),
                                       params, jc, jnp.asarray(BOX))
    t_render = TT.make_render_fn(pm, TT.TrainConfig(far=3.0))
    got = tocc.render_occlusion_layers(lambda c, i, aabb_box=None: t_render(c, i, 8, 8, aabb_box=aabb_box), tc, BOX)
    for k in ("occlusion_rgb", "occlusion_mask", "background_rgb"):
        assert getattr(got, k).shape == getattr(ref, k).shape
        _close(getattr(got, k), getattr(ref, k), 2e-2, 1e-4)
    # the layers are not empty: the box splits each ray into both
    assert float(got.occlusion_mask.mean()) > 0.05 and float(got.background_rgb.mean()) > 0.0


def test_envmap_guiding_matches_jax(tmp_path):
    """EnvGuiding from an .npy path and from the data directory's env.exr,
    and EmitterImageGuiding from an .exr, against JAX's envmaps: the image,
    its row and conditional CDFs (1e-6); the registry's names."""
    img = np.random.default_rng(1).uniform(0.1, 3.0, size=(8, 16, 4)).astype(np.float32)
    np.save(tmp_path / "env.npy", img)
    texr.write_exr(tmp_path / "env.exr", img[..., :3])
    texr.write_exr(tmp_path / "relight.exr", img[..., 1:])
    pairs = [(tpg.EnvGuiding(env_path=str(tmp_path / "env.npy")).build_envmap(tmp_path, device="cpu"),
              jpg.EnvGuiding(env_path=str(tmp_path / "env.npy")).build_envmap(tmp_path)),
             (tpg.EnvGuiding().build_envmap(tmp_path, device="cpu"), jpg.EnvGuiding().build_envmap(tmp_path)),
             (tpg.EmitterImageGuiding(tmp_path / "relight.exr").build_envmap(device="cpu"),
              jpg.EmitterImageGuiding(tmp_path / "relight.exr").build_envmap())]
    for got, ref in pairs:
        for k in ("image", "row_cdf", "cond_cdf"):
            _close(getattr(got, k), getattr(ref, k), 1e-6, 1e-6)
    assert np.abs(pairs[0][0].image.numpy() - img[..., :3]).max() == 0.0
    assert sorted(tpg.GUIDING_REGISTRY) == sorted(jpg.GUIDING_REGISTRY)
    # the port's EXR reader reads the JAX package's file
    jexr.write_exr(tmp_path / "j.exr", img[..., :3])
    assert np.array_equal(texr.read_exr(tmp_path / "j.exr"), jexr.read_exr(tmp_path / "j.exr"))


# ---- the pipeline


def _opt_configs(**kw):
    """The pipeline tests' recipe on both sides: tests/test_pipeline.py's
    tiny one (17^3, 4^3 textures, no redistancing, no curvature), with
    `kw` replaced."""
    specs = dict(variables=None, init_res=17, tex_res=4, render_upsample_iter=(), curvature_mult=0.0, **kw)

    def make(mod):
        variables = specs["variables"] or (mod.VariableSpec("sdf", lr=3e-3, redistance_freq=0),
                                           mod.VariableSpec("albedo", lr=1e-2, clamp=(0.0, 1.0)),
                                           mod.VariableSpec("roughness", lr=0.0, clamp=(0.02, 1.0)))
        return mod.SdfOptConfig(name="tiny", bsdf_type=0, loss="relative_l1", **dict(specs, variables=variables))

    return make(jopt), make(topt)


def _j_pipeline(**attrs):
    """A JAX NerfEmitterPipeline without its __init__: its methods read only
    the attributes given."""
    jp = object.__new__(jne.NerfEmitterPipeline)
    jp.mesh, jp.data_axis, jp.rotater, jp.occlusion = None, None, None, None
    for k, v in attrs.items():
        setattr(jp, k, v)
    return jp


def test_pipeline_tsdf_init_matches_jax(monkeypatch):
    """NerfEmitterPipeline.tsdf_init from the same tiny `freq` NeRF on 6 ring
    views of 24^2 (depth at 12^2, fused at 24^3, resampled to 17^3). With
    the field's density raised (output bias +5: a dense box) the depth
    images agree within 1e-3 where both are solid, the accumulation > 0.3
    mask flips on no more than 1% of the pixels (measured: none), and the
    SDF within 1e-4 (measured 8.8e-6) with an interior; with the NeRF as
    initialised no ray reaches 0.3, and both fall back to the same
    sphere."""
    jm, params0, _ = freq_pair()
    jc, tc = _ring(n=6, size=24)
    j_opt, t_opt = _opt_configs()
    cfg = dict(tsdf_init_res=24, tsdf_depth_downscale=2)
    seen = {}
    for side, mod in (("j", jtsdf), ("t", ttsdf)):
        def spy(cams, depth, _orig=mod.tsdf_init_sdf, _side=side, **kw):
            seen[_side] = np.asarray(depth)
            return _orig(cams, depth, **kw)

        monkeypatch.setattr(mod, "tsdf_init_sdf", spy)
    j_render = JT.make_render_fn(jm, JT.TrainConfig(far=3.0))
    for bias in (5.0, 0.0):
        params = jax.tree.map(np.array, params0)
        params["params"]["field"]["base_mlp"]["out"]["bias"][0] += bias
        jp = _j_pipeline(dataset=JImageDataset(cameras=jc, images=jnp.zeros((6, 24, 24, 3))),
                         config=jne.NerfEmitterPipelineConfig(**cfg), render_fn=j_render,
                         nerf_state=types.SimpleNamespace(params=params),
                         object_aabb=jnp.asarray(BOX), opt_config=j_opt)
        ref = jp.tsdf_init()
        pm = load_flax_params(NerfactoModel(AABB, device="cpu", **FREQ), params)
        tp = tne.NerfEmitterPipeline(tne.NerfEmitterPipelineConfig(**cfg), pm, TT.TrainConfig(far=3.0), t_opt,
                                     ImageDataset(cameras=tc, images=torch.zeros(6, 24, 24, 3)))
        got = tp.tsdf_init()
        solid_j, solid_t = seen["j"] < 1e3, seen["t"] < 1e3
        assert (solid_j != solid_t).mean() <= 0.01
        both = solid_j & solid_t
        if bias:
            assert both.mean() > 0.3
            _close(seen["t"][both], seen["j"][both], 0, 1e-3)
            _close(got.sdf, ref.sdf, 0, 1e-4)
            assert float((got.sdf < 0).float().mean()) > 0.0
        else:
            assert not both.any()
            _close(got.sdf, ref.sdf, 0, 0)
        assert got.albedo.shape == ref.albedo.shape == (4, 4, 4, 3)
        assert float(got.albedo.mean()) == float(got.roughness.mean()) == 0.5


# (init_res, the sdf's upsample steps, render_upsample_iter, image size,
#  takeover_image_size, spp, spp_attached, mean_start, mi_opt_steps)
SCHEDULES = [
    (64, (64, 128), (64, 128, 192), 256, 64, 32, 16, None, 320),  # sdf-nerfacto's
    (17, (2, 4), (2, 4, 6), 1024, 128, 8, 16, 5, 10),  # 512 pixels: spp halves; spp_attached capped
    (9, (1,), (1, 3), 24, 16, 2, 0, None, 4),  # the image size caps the render; exact gradients
    (33, (3, 5), (3, 5, 7), 2048, 256, 64, 64, 0, 100),  # spp halves twice
]


def _schedule_pipelines(case, tmp_path):
    """Both packages' pipelines at a schedule case, their takeover step
    builders replaced by recorders of the TakeoverConfig."""
    init_res, ups, render_ups, cap, size, spp, spp_att, mean_start, mi_steps = case
    np.save(tmp_path / "env.npy", np.ones((4, 8, 3), np.float32))
    pipe = dict(takeover_image_size=size, spp=spp, spp_attached=spp_att, mean_start=mean_start,
                mi_opt_steps=mi_steps, guiding_type="env", env_path=str(tmp_path / "env.npy"))
    specs = {}
    for name, mod in (("j", jopt), ("t", topt)):
        specs[name] = (mod.VariableSpec("sdf", lr=3e-3, upsample_iters=ups, smooth_lam=2.0, optimizer="uniform_adam",
                                        lr_decay_at_up=0.25),
                       mod.VariableSpec("albedo", lr=4.5e-3, clamp=(0.0, 1.0), lr_decay_at_up=0.5),
                       mod.VariableSpec("roughness", lr=3e-3, clamp=(0.02, 1.0)))
    j_opt, t_opt = (dataclasses.replace(c, render_upsample_iter=render_ups, init_res=init_res, variables=specs[n])
                    for c, n in zip(_opt_configs(), "jt"))
    jc, tc = _ring(n=2, size=cap)
    jp = _j_pipeline(config=jne.NerfEmitterPipelineConfig(**pipe), opt_config=j_opt,
                     mi_dataset=JImageDataset(cameras=jc, images=jnp.zeros((2, 1, 1, 3))),
                     render_config=ji.RenderConfig(), data_dir=tmp_path, _takeover_emitter_fn=None,
                     _takeover_emitter_for_camera=None)
    model = NerfactoModel(AABB, device="cpu", num_nerf_samples=8, num_proposal_samples=(8, 8), log2_hashmap_size=8,
                          max_res=16, num_cameras=2, appearance_embedding_dim=4)
    tp = tne.NerfEmitterPipeline(tne.NerfEmitterPipelineConfig(**pipe), model, TT.TrainConfig(), t_opt,
                                 ImageDataset(cameras=tc, images=torch.zeros(2, 1, 1, 3)))
    tp.data_dir = tmp_path
    for p in (jp, tp):
        p.begin_takeover_template()
        p._takeover_size, p._takeover_spp = size, spp
        p._takeover_emitter_fn = p._takeover_emitter_for_camera = None
        p._rebuild_sdf_step_fn()
    return jp, tp, ups, render_ups


def _takeover_fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tso.TakeoverConfig)}


def _schedule_state(p) -> tuple:
    return p._takeover_size, p._takeover_spp, dict(p._lr_up_scale), _takeover_fields(p.sdf_step_fn)


@pytest.mark.parametrize("case", SCHEDULES, ids=[f"init{c[0]}_size{c[4]}_cap{c[3]}" for c in SCHEDULES])
def test_takeover_schedule_matches_jax(case, tmp_path, monkeypatch):
    """The takeover's schedule arithmetic, step by step over a table of
    cases: _maybe_upsample_render_res (the render size and spp),
    _apply_volume_upsample_lr_decay at each volume upsample (the lr
    scales), the TakeoverConfig that _rebuild_sdf_step_fn builds (spp per
    batch, the capped spp_attached, mean_start), and resume_takeover_bind's
    replay from each upsampled grid, all equal to JAX's."""
    for mod in (jne, tne):
        monkeypatch.setattr(mod, "make_sdf_train_step", lambda opt, takeover, tx, **kw: takeover)
    jp, tp, ups, render_ups = _schedule_pipelines(case, tmp_path)
    seen = {}
    for mi in range(max(render_ups) + 2):
        for p in (jp, tp):
            p._maybe_upsample_render_res(mi)
            if mi in ups:  # post_step_host's volume upsample
                res = int(p.sdf_state.scene.sdf.shape[0]) * 2 - 1
                sdf = (jnp.zeros if p is jp else torch.zeros)((res, res, res, 1))
                p.sdf_state = p.sdf_state.replace(scene=p.sdf_state.scene.replace(sdf=sdf))
                p._apply_volume_upsample_lr_decay()
        assert _schedule_state(tp) == _schedule_state(jp), mi
        seen[int(tp.sdf_state.scene.sdf.shape[0])] = _schedule_state(tp)
    assert len(seen) == len(ups) + 1
    for res, walked in seen.items():
        jr, tr = _schedule_pipelines(case, tmp_path)[:2]
        for p in (jr, tr):
            p.begin_takeover_template(sdf_res=res)
        jr.resume_takeover_bind(jax.random.PRNGKey(0))
        tr.resume_takeover_bind(torch.Generator())
        assert _schedule_state(tr) == _schedule_state(jr), res
        # the replayed lr scales are the walk's (its render size follows the
        # volume upsamples only, the walk's render_upsample_iter)
        assert _schedule_state(tr)[2] == walked[2]


def test_takeover_iteration_matches_jax():
    """One takeover_iteration from one state at tests/test_pipeline.py's
    tiny size: the 17^3 composite object with a vMF mixture, 4 ring views of
    24^2 rendered at 16^2, 2 cameras a step, spp 2 (spp_attached capped to
    2: the banded path, exact), the soft silhouette and one-sample MIS, a
    per-camera analytic emitter. The state is JAX's after one update of
    random gradients (step 1, Adam moments, running means), carried across
    by bridge.load_sdf_opt_state; JAX's camera pick and step draws are
    handed to the port. With load_mean_step 1 the step ends in the swap to
    the running means. Held: the loss terms (relative 1e-4); the gradient
    norms at relative 1e-3, the gradients' bar in
    tests/test_torch_sdf_opt.py (measured 1.2e-4 for the sdf's); the
    swapped sdf (1e-5 of the step) and albedo (1e-6: the first update's
    random moments set its step, so no voxel's update rests on a
    roundoff-level gradient); the first moments where clear of roundoff
    (1e-3 of their largest); the step and mean counts."""
    js, _ = scene_pair("vmf", res=17)
    j_opt, t_opt = _opt_configs()
    j_fn, t_fn = emitter_fns()
    jc, tc = _ring(n=4, size=24, focal=22.0)
    rng = np.random.default_rng(7)
    gt = rng.uniform(0.2, 1.5, size=(4, 24, 24, 3)).astype(np.float32)
    yy, xx = np.mgrid[:24, :24]
    mask = np.broadcast_to((((yy - 11.5) ** 2 + (xx - 11.5) ** 2) < 50.0)[None, :, :, None], (4, 24, 24, 1))
    mask = mask.astype(np.float32)
    cfg = dict(batch_size=2, spp=2, takeover_image_size=16, load_mean_step=1, mean_start=0, mi_opt_steps=2)
    render = dict(trace=TRACE, mis_mode="one_sample", reparam="soft", warp_secondary=False)

    j_tx = jso.build_sdf_optimizer(j_opt)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), js)
    _, j_opt_state = j_tx.update(grads, j_tx.init(js), js)
    means = {k: v + 0.01 for k, v in jso.init_mean_params(js).items()}
    j_state = jso.SdfOptState(step=jnp.int32(1), scene=js, opt_state=j_opt_state, mean_params=means,
                              mean_count=jnp.int32(1))
    t_tx = tso.build_sdf_optimizer(t_opt)
    # copies: JAX's step donates its state
    t_state = load_sdf_opt_state(jax.tree.map(np.array, j_state), t_tx)
    mean_sdf = np.array(means["sdf"])

    jp = _j_pipeline(config=jne.NerfEmitterPipelineConfig(**cfg), opt_config=j_opt,
                     mi_dataset=JImageDataset(cameras=jc, images=jnp.asarray(gt), masks=jnp.asarray(mask)),
                     render_config=ji.RenderConfig(**dict(render, trace=jst.SphereTraceConfig(**TRACE))),
                     sdf_tx=j_tx, sdf_state=j_state, _lr_up_scale={}, _takeover_size=16, _takeover_spp=2,
                     _takeover_emitter_fn=None, guiding=jpg.VMFGuiding(),
                     _takeover_emitter_for_camera=lambda c, r: lambda x, d: j_fn(x, d) * (1.0 + 0.1 * c))
    jp._rebuild_sdf_step_fn()
    model = NerfactoModel(AABB, device="cpu", num_nerf_samples=8, num_proposal_samples=(8, 8), log2_hashmap_size=8,
                          max_res=16, num_cameras=4, appearance_embedding_dim=4)
    tp = tne.NerfEmitterPipeline(tne.NerfEmitterPipelineConfig(**cfg), model, TT.TrainConfig(), t_opt,
                                 ImageDataset(cameras=tc, images=t_(gt), masks=t_(mask)),
                                 render_config=ti.RenderConfig(**dict(render, trace=tst.SphereTraceConfig(**TRACE))))
    tp.sdf_tx, tp.sdf_state, tp._lr_up_scale, tp._takeover_size, tp._takeover_spp = t_tx, t_state, {}, 16, 2
    tp._takeover_emitter_fn = None
    tp._takeover_emitter_for_camera = lambda c, r: lambda x, d: t_fn(x, d) * (1.0 + 0.1 * c)
    tp._rebuild_sdf_step_fn()
    assert (tp.sdf_step_fn.aggregate, tp.sdf_step_fn.chunks, tp.sdf_step_fn.n_grad_bands) == (True, [], 1)

    key = jax.random.PRNGKey(11)
    k_pick, k_step = jax.random.split(key)
    cam_idx = np.asarray(jax.random.choice(k_pick, 4, (2,), replace=False))
    draws = _j_step_draws(tp.sdf_step_fn, k_step, js, 2)
    j_m = jp.takeover_iteration(key)
    t_m = tp.takeover_iteration(torch.Generator(), cam_idx=torch.tensor(cam_idx).long(), draws=draws)
    for k in ("loss", "view_loss", "mask_loss", "curvature", "laplacian"):
        _close(t_m[k], j_m[k], 1e-4, 1e-7)
    for k in ("gnorm_sdf", "gnorm_albedo"):  # the gradients' bar (tests/test_torch_sdf_opt.py)
        _close(t_m[k], j_m[k], 1e-3, 0)
    jn, tn = jp.sdf_state, tp.sdf_state
    assert tn.step == int(jn.step) == 2 and tn.mean_count == int(jn.mean_count) == 2
    # the swap: the scene is the running means
    for k in ("sdf", "albedo", "roughness"):
        assert torch.equal(getattr(tn.scene, k), tn.mean_params[k])
    step_size = np.abs(np.asarray(jn.scene.sdf) - mean_sdf).max() * 2
    _close(tn.scene.sdf, jn.scene.sdf, 0, 1e-5 * step_size)
    for k in ("sdf", "albedo"):
        got = tn.opt_state[k][-1] if isinstance(tn.opt_state[k], tuple) else tn.opt_state[k]
        ref = _first(jn.opt_state.inner_states[k], _is_moments)
        mu = np.asarray(getattr(ref.mu if hasattr(ref, "mu") else ref["mu"], k))
        assert got["count"] == int(np.asarray(ref.count if hasattr(ref, "count") else ref["count"])) == 2
        # the first moments, where they are clear of roundoff
        clear = np.abs(mu) > 1e-2 * np.abs(mu).max()
        _close(got["mu"], mu, 0, 1e-3 * np.abs(mu).max(), clear)
    # the random moments of the first update dominate the albedo's step
    _close(tn.scene.albedo, jn.scene.albedo, 0, 1e-6)


# ---- the slice as a whole (the port alone, as tests/test_pipeline.py runs JAX)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    """tests/test_pipeline.py's fixture on the port: 6 synthetic views of
    24^2 (all in the train split) and the tiny hash NeRF."""
    from nerf_emitter_tpu_torch.data.datamanager import build_dataset
    from nerf_emitter_tpu_torch.data.dataparsers.instant_ngp import InstantNGPDataparserConfig, parse_instant_ngp
    from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset

    d = tmp_path_factory.mktemp("scene")
    make_synthetic_dataset(d, n_views=6, width=24, height=24)
    return build_dataset(parse_instant_ngp(InstantNGPDataparserConfig(data=d, eval_mode="all"), "train"),
                         device="cpu")


def _two_phase(dataset, tmp_path, **kw):
    torch.manual_seed(0)
    model = NerfactoModel(AABB, device="cpu", num_nerf_samples=8, num_proposal_samples=(12, 8), log2_hashmap_size=12,
                          max_res=128, num_cameras=6, appearance_embedding_dim=4)
    cfg = dict(takeover_step=3, mi_opt_steps=2, scene_scale=1.0, object_aabb=BOX, proposal_rebuild_every=10,
               tsdf_init_res=24, tsdf_depth_downscale=2, batch_size=2, spp=2, takeover_image_size=16)
    cfg.update(kw)
    pipe = tne.NerfEmitterPipeline(
        tne.NerfEmitterPipelineConfig(**cfg), model,
        TT.TrainConfig(num_rays_per_batch=128, near=0.05, far=3.0, max_steps=20, anneal_steps=5), _opt_configs()[1],
        dataset, render_config=ti.RenderConfig(trace=tst.SphereTraceConfig(max_steps=16, t_max=3.0)))
    pipe.data_dir = tmp_path
    pipe.guiding.downscale, pipe.guiding.n_clusters, pipe.guiding.max_points = 8, 4, 256
    g = torch.Generator().manual_seed(0)
    metrics = [pipe.train_iteration(step, g) for step in range(cfg["takeover_step"] + 2)]
    assert pipe.sdf_state is not None and pipe.sdf_state.step == 2
    for m in metrics:
        assert all(np.isfinite(float(v)) for v in m.values()), m
    out = pipe.render_camera_outputs(dataset, 0, torch.Generator().manual_seed(9), spp=2)
    assert {k: tuple(v.shape) for k, v in out.items()} == {"rgb": (24, 24, 3), "depth": (24, 24, 1),
                                                            "normal": (24, 24, 3), "accumulation": (24, 24, 1)}
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    return pipe, metrics


def test_port_two_phase_vmf_distilled(tiny_scene, tmp_path, monkeypatch):
    """sdf-nerfacto at the tiny size: 3 NeRF steps, the takeover (TSDF
    init, the vMF guiding, the light-field cache distilled for 8 steps of
    2^10 queries, the default 2^14 cut for the CPU), 2 takeover steps and
    a served view: every metric finite, the guiding loaded, the fidelity
    finite, the served view's shapes."""
    monkeypatch.setattr(tne, "DistillConfig", functools.partial(tne.DistillConfig, batch=1 << 10))
    pipe, metrics = _two_phase(tiny_scene, tmp_path, guiding_type="vmf", distill_emitter=True, distill_steps=8)
    assert "rgb_loss" in metrics[0] and "view_loss" in metrics[-1]
    g = pipe.sdf_state.scene.guiding
    assert g is not None and g.positions.shape == (4, 3) and pipe.sdf_state.scene.envmap is None
    assert np.isfinite(pipe.distill_fidelity["rmse_log"]) and pipe._serving_use_nerf


def test_port_two_phase_gt_envmap(tiny_scene, tmp_path):
    """sdf-gt-envmap at the tiny size: the takeover at step 0 from a sphere,
    lit by the GT envmap from an .npy; 2 steps and a served view; the eval
    split's average metrics; relit by another envmap (the JAX suite's
    test_set_relight_emitter_public_api), the view changes."""
    np.save(tmp_path / "env.npy", np.full((8, 16, 3), 1.2, np.float32))
    pipe, _ = _two_phase(tiny_scene, tmp_path, takeover_step=0, guiding_type="env",
                         env_path=str(tmp_path / "env.npy"), mis_mode="both")
    scene = pipe.sdf_state.scene
    assert scene.envmap is not None and scene.guiding is None and not pipe._serving_use_nerf
    # the eval split's averages; then relit by another envmap, the view changes
    m = pipe.get_average_eval_image_metrics(tiny_scene, torch.Generator().manual_seed(1), spp=1, get_std=True)
    assert {"psnr", "ssim", "mape", "psnr_std"} <= set(m) and all(np.isfinite(v) for v in m.values())
    before = pipe.render_camera_outputs(tiny_scene, 0, torch.Generator().manual_seed(9), spp=2)["rgb"]
    env = np.zeros((8, 16, 3), np.float32)
    env[:, :8] = 4.0
    texr.write_exr(tmp_path / "relit.exr", env)
    pipe.set_relight_emitter(tmp_path / "relit.exr")
    after = pipe.render_camera_outputs(tiny_scene, 0, torch.Generator().manual_seed(9), spp=2)["rgb"]
    assert bool(torch.isfinite(after).all()) and float((after - before).abs().max()) > 1e-3


def test_fold_in_and_the_dummy_model():
    """fold_in derives a generator from a generator's state and a number
    without advancing it (jax.random.fold_in's role): the same state and
    number give the same draws, another number other draws. DummyModel
    answers zeros of the ray batch's shape and scores with
    eval_image_metrics."""
    from nerf_emitter_tpu_torch.cameras.rays import RayBundle
    from nerf_emitter_tpu_torch.models.dummy import DummyModel

    g = torch.Generator().manual_seed(3)
    a, b, c = (torch.rand(4, generator=tne.fold_in(g, k)) for k in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.rand(4, generator=g), torch.rand(4, generator=torch.Generator().manual_seed(3)))
    rays = RayBundle(origins=torch.zeros(5, 3), directions=torch.ones(5, 3), pixel_area=torch.ones(5, 1),
                     nears=torch.zeros(5, 1), fars=torch.ones(5, 1), camera_indices=torch.zeros(5, 1, dtype=torch.long))
    out = DummyModel(device="cpu")(rays)
    assert {k: tuple(v.shape) for k, v in out.items()} == {"rgb": (5, 3), "depth": (5, 1), "accumulation": (5, 1)}
    assert all(float(v.abs().sum()) == 0 for v in out.values())
    img = torch.rand(8, 8, 3, generator=g)
    assert DummyModel.get_image_metrics(img * 0.5, img) == TT.eval_image_metrics(img * 0.5, img)
