"""The port's guiding build against the JAX package: camera rays in every
crop mode and the equirect rig, `point_lights` (its brightness gradient a
jvp), the light point cloud, `compensate_pc`, the spherical-GMM EM, the vMF
mixture, and `VMFGuiding.build` end to end.

The NeRF is the tiny hash model of tests/test_torch_hash.py with its hash
tables scaled up to +-1, so the field has structure to find (at the 1e-4
init it is nearly constant). JAX keys and torch generators never agree:
where JAX draws (GMM seeds, vMF lobes and angles), the test reproduces
JAX's draws and hands them to the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.cameras import Cameras as JCameras
from nerf_emitter_tpu.cameras.cameras import make_spherical_rig as j_rig
from nerf_emitter_tpu.data.scene_box import CropMode as JCropMode
from nerf_emitter_tpu.data.scene_box import SceneBox as JSceneBox
from nerf_emitter_tpu.guiding.gmm import fit_spherical_gmm as j_fit
from nerf_emitter_tpu.guiding.light_pc import compensate_pc as j_compensate
from nerf_emitter_tpu.guiding.light_pc import extract_light_point_cloud as j_extract
from nerf_emitter_tpu.guiding.path_guiding import VMFGuiding as JVMFGuiding
from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.renderer.emitters import VMFMixture as JVMF
from nerf_emitter_tpu_torch.bridge import load_flax_params
from nerf_emitter_tpu_torch.cameras.cameras import Cameras, make_spherical_rig
from nerf_emitter_tpu_torch.data.scene_box import CropMode, SceneBox
from nerf_emitter_tpu_torch.guiding.gmm import fit_spherical_gmm
from nerf_emitter_tpu_torch.guiding.light_pc import compensate_pc, extract_light_point_cloud
from nerf_emitter_tpu_torch.guiding.path_guiding import VMFGuiding
from nerf_emitter_tpu_torch.renderer.emitters import VMFMixture
from nerf_emitter_tpu_torch.utils import coords, profiler
from test_torch_hash import ATOL, OBJECT_BOX, RTOL, _both, _rays_np, hash_pair

torch.set_num_threads(1)


def lit_pair():
    """hash_pair with its hash tables uniform in +-1 (the same draw on both
    sides)."""
    jm, params, pm = hash_pair(seed=1)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(12)
    for name in ("field", "proposal_0", "proposal_1"):
        t = tree["params"][name]["hash_table"]
        tree["params"][name]["hash_table"] = rng.uniform(-1.0, 1.0, size=t.shape).astype(np.float32)
    load_flax_params(pm, tree)
    return jm, jax.tree.map(jnp.asarray, tree), pm


def _ring_c2w(n=4, radius=2.0, height=0.3):
    """n cameras on a ring around the origin, looking at it (OpenGL)."""
    out = []
    for i in range(n):
        a = 2.0 * math.pi * i / n
        o = np.array([radius * math.sin(a), height, radius * math.cos(a)])
        f = -o / np.linalg.norm(o)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r /= np.linalg.norm(r)
        u = np.cross(r, f)
        out.append(np.stack([r, u, -f, o], axis=1))
    return np.stack(out).astype(np.float32)


def _cameras(n=4, size=16):
    c2w = _ring_c2w(n)
    f = np.full(n, float(size), np.float32)
    c = np.full(n, size / 2.0, np.float32)
    jc = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(f), fy=jnp.asarray(f),
                  cx=jnp.asarray(c), cy=jnp.asarray(c), width=size, height=size)
    tc = Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(f), fy=torch.from_numpy(f),
                 cx=torch.from_numpy(c), cy=torch.from_numpy(c), width=size, height=size)
    return jc, tc


def _close(t, j, rtol=1e-6, atol=1e-6, msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=msg)


def _bundles_close(tb, jb, atol=1e-6):
    for k in ("origins", "directions", "pixel_area", "nears", "fars", "camera_indices"):
        _close(getattr(tb, k).float(), np.asarray(getattr(jb, k), np.float32), atol=atol, msg=k)


@pytest.mark.parametrize("mode", [m.name for m in CropMode] + ["FAR_from_world"])
def test_generate_rays_in_every_crop_mode_matches_jax(mode):
    """Perspective rays of a ring of cameras, clipped by the object box in
    each crop mode (one with a world -> box transform), with jitter and
    pose deltas on the FAR2INF case."""
    jc, tc = _cameras()
    rng = np.random.default_rng(13)
    idx = rng.integers(0, 4, size=64).astype(np.int32)
    pix = rng.integers(0, 16, size=(64, 2)).astype(np.int32)
    name = mode.split("_")[0]
    kw_j, kw_t = {}, {}
    if mode == "FAR_from_world":
        fw = np.eye(4, dtype=np.float32)
        fw[:3, 3] = [0.1, -0.05, 0.2]
        kw_j["from_world"], kw_t["from_world"] = jnp.asarray(fw), torch.from_numpy(fw)
    jbox = JSceneBox(aabb=jnp.asarray(OBJECT_BOX), crop_mode=JCropMode[name], **kw_j)
    tbox = SceneBox(aabb=torch.tensor(OBJECT_BOX), crop_mode=CropMode[name], **kw_t)
    extra_j, extra_t = {}, {}
    if name == "FAR2INF":
        jit = rng.uniform(size=(64, 2)).astype(np.float32)
        deltas = rng.normal(scale=0.01, size=(4, 3, 4)).astype(np.float32)
        extra_j = dict(jitter=jnp.asarray(jit), pose_deltas=jnp.asarray(deltas))
        extra_t = dict(jitter=torch.from_numpy(jit), pose_deltas=torch.from_numpy(deltas))
    jb = jc.generate_rays(jnp.asarray(idx), jnp.asarray(pix), nears=0.05, fars=5.0, aabb_box=jbox, **extra_j)
    tb = tc.generate_rays(torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(pix.astype(np.int64)),
                          nears=0.05, fars=5.0, aabb_box=tbox, **extra_t)
    _bundles_close(tb, jb, atol=1e-5)
    assert tbox.within(torch.zeros(1, 3)).item() and not tbox.within(torch.ones(1, 3)).item()
    _close(tbox.get_center(), jbox.get_center())
    _close(tbox.get_diagonal_length(), jbox.get_diagonal_length())


def test_equirect_rig_matches_jax():
    """The light-probe rig: all rays of one equirect camera, (H, W, ...)."""
    center = np.array([0.1, 0.2, -0.1], np.float32)
    jb = j_rig(jnp.asarray(center), width=16, height=8).generate_image_rays(0, nears=0.05, fars=3.0)
    tb = make_spherical_rig(torch.from_numpy(center), width=16, height=8).generate_image_rays(
        0, nears=0.05, fars=3.0)
    assert tb.origins.shape == (8, 16, 3) and tb.nears.shape == (8, 16, 1)
    _bundles_close(tb, jb, atol=2e-6)


def test_point_lights_match_jax_at_a_finite_far():
    """All four outputs at far = 3, with the carve-out: the black-background
    radiance, its luminance, the contrib depth, and the brightness gradient
    along the ray, torch.func.jvp against jax.jvp. With +-1 tables the bf16
    MLPs round a few hidden units differently in the two frameworks
    (the eval forward's rgb moves by 3e-4 relative on the same rays); the
    bar is rtol 1e-3 (measured: rgb 1.5e-4, luminance 1.0e-4, depth 1.1e-6)
    and for the gradient 2e-3 of its largest value (measured 5.3e-4)."""
    jm, params, pm = lit_pair()
    jr, tr = _both(_rays_np(32, seed=14, far=3.0))
    box = jnp.asarray(OBJECT_BOX)
    ref = jm.apply(params, jr, disable_aabb=box, disable_aabb_on=True, method=JModel.point_lights)
    out = pm.point_lights(tr, disable_aabb=torch.tensor(OBJECT_BOX), disable_aabb_on=True)
    jg = np.asarray(ref["brightness_grad"])
    assert float(np.abs(jg).max()) > 1e-2  # a gradient to hold
    for k in ("rgb", "luminance", "depth", "brightness_grad"):
        assert out[k].shape == ref[k].shape, k
    for k in ("rgb", "luminance", "depth"):
        _close(out[k], ref[k], rtol=1e-3, atol=1e-5, msg=k)
    assert np.abs(out["brightness_grad"].detach().numpy() - jg).max() <= 2e-3 * np.abs(jg).max()


def test_light_point_cloud_at_inf_far():
    """The light probes of a ring of cameras at 1/4 resolution, FAR2INF
    (fars = INF_FAR = 1e6), against JAX. At that far the resampled bins
    carry the ramp form's ~1e-4 cancellation over a spacing range that
    reaches 1e6 (ROADMAP.md, Queue 3 item 1), and the contrib depth is an
    argmax, so a near tie jumps a sample. Held: the luminance within 2%
    (measured: median 7.5e-5, max 1.2%), the points within 1e-3 on 95% of
    the rays (measured: 252 of 256; median 1e-6) and within 0.2 on all
    (measured max 0.137, a jump of the argmax). Reported, not held beyond
    finiteness: rgb (measured max 1.5% relative) and the brightness
    gradient (measured max 0.53, 40% of its largest value)."""
    jm, params, pm = lit_pair()
    jc, tc = _cameras(size=32)
    ref = j_extract(jm, params, jc, object_aabb=jnp.asarray(OBJECT_BOX), downscale=4, chunk=32)
    out = extract_light_point_cloud(pm, tc, object_aabb=torch.tensor(OBJECT_BOX), downscale=4, chunk=24)
    assert out["points"].shape == (4 * 64, 3) and out["brightness_grad"].shape == (4 * 64,)
    for k in ("points", "luminance", "rgb", "brightness_grad"):
        assert bool(torch.isfinite(out[k]).all()), k
    _close(out["luminance"], ref["luminance"], rtol=2e-2, atol=1e-6, msg="luminance")
    err = np.abs(out["points"].numpy() - np.asarray(ref["points"])).max(axis=1)
    assert (err <= 1e-3).mean() >= 0.95 and err.max() <= 0.2, np.quantile(err, [0.5, 0.95, 1.0])


def _probe_cameras(n=3, height=5, width=7):
    """n ring cameras of height x width pixels (not square, so rows and
    columns cannot be swapped unseen)."""
    c2w = _ring_c2w(n)
    f = np.full(n, float(width), np.float32)
    return Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(f), fy=torch.from_numpy(f),
                   cx=torch.from_numpy(np.full(n, width / 2.0, np.float32)),
                   cy=torch.from_numpy(np.full(n, height / 2.0, np.float32)), width=width, height=height)


def _per_camera_probes(model, cams, box, chunk):
    """The light probes as one loop per camera, each camera's row-major
    pixels in chunks of `chunk`: the grouping the batched extraction
    replaces."""
    h, w = cams.height, cams.width
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    coords = torch.stack([yy, xx], dim=-1).reshape(-1, 2)
    outs = {"points": [], "luminance": [], "rgb": [], "brightness_grad": []}
    with torch.no_grad():
        for ci in range(len(cams)):
            for start in range(0, coords.shape[0], chunk):
                co = coords[start:start + chunk]
                idx = torch.full((co.shape[0],), ci, dtype=torch.long)
                rays = cams.generate_rays(idx, co, nears=0.05, fars=1e3, aabb_box=box)
                out = model.point_lights(rays)
                outs["points"].append(rays.origins + rays.directions * out["depth"])
                for k in ("luminance", "rgb", "brightness_grad"):
                    outs[k].append(out[k])
    return {k: torch.cat(v) for k, v in outs.items()}


@pytest.mark.parametrize("rig", [False, True], ids=["cameras", "spherical_rig"])
def test_probes_batched_across_cameras_equal_the_per_camera_loop(rig):
    """The probe rays of all cameras in chunks that cross cameras (3
    cameras of 5 x 7 pixels in chunks of 16, the last partial; or the
    spherical rig, one 9 x 4 camera in chunks of 16) give the per-camera
    loop's points, luminance, rgb and brightness gradient row for row, each
    ray lit with its own camera's appearance embedding."""
    _, _, pm = lit_pair()
    box = SceneBox(aabb=torch.tensor(OBJECT_BOX), crop_mode=CropMode.FAR2INF)
    center = torch.tensor([0.05, 0.6, -0.1])
    if rig:
        cams = make_spherical_rig(center, width=9, height=4)
        out = extract_light_point_cloud(pm, None, object_aabb=torch.tensor(OBJECT_BOX), chunk=16,
                                        use_spherical_rig=True, rig_center=center, rig_res=(9, 4))
    else:
        cams = _probe_cameras()
        out = extract_light_point_cloud(pm, cams, object_aabb=torch.tensor(OBJECT_BOX), downscale=1, chunk=16)
    ref = _per_camera_probes(pm, cams, box, chunk=16)
    n = len(cams) * cams.height * cams.width
    assert n % 16 != 0 and ref["luminance"].shape == (n,)
    assert float(ref["luminance"].std()) > 0.0  # rays that differ
    for k in ("points", "luminance", "rgb", "brightness_grad"):
        assert out[k].shape == ref[k].shape and out[k].dtype == ref[k].dtype, k
        _close(out[k], ref[k].numpy(), rtol=RTOL, atol=ATOL, msg=k)


def test_probe_calls_count_the_chunks(monkeypatch):
    """guiding.probe_calls counts one per point_lights call, ceil(rays /
    chunk) of them across cameras, and guiding.probe_rays every probe ray."""
    _, _, pm = lit_pair()
    calls = []
    real = pm.point_lights

    def point_lights(rays, **kw):
        calls.append(rays.origins.shape[0])
        return real(rays, **kw)

    monkeypatch.setattr(pm, "point_lights", point_lights)
    profiler.reset()
    profiler.enable()
    try:
        extract_light_point_cloud(pm, _probe_cameras(), object_aabb=torch.tensor(OBJECT_BOX), downscale=1,
                                  chunk=16)
        c = profiler.counters()
    finally:
        profiler.disable()
        profiler.reset()
    assert calls == [16] * 6 + [9]
    assert c["guiding.probe_calls"] == math.ceil(105 / 16) == len(calls)
    assert c["guiding.probe_rays"] == 105


def _multiset(pts, w):
    """The positive-weight (point, weight) rows, sorted."""
    keep = w > 0
    rows = np.concatenate([np.asarray(pts)[keep], np.asarray(w)[keep][:, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("mean_mult", [1.0, 0.0], ids=["mis_compensation", "raw"])
def test_compensate_pc_matches_jax_as_a_multiset(mean_mult):
    """After the mean subtraction most weights are exactly 0, and top-k
    orders ties its own way in each framework: the kept set is held as a
    multiset of positive-weight (point, weight) rows, the zero count and
    the weighted moments."""
    rng = np.random.default_rng(15)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    # dim points below the mean (weights tie at 0 after the subtraction),
    # bright ones above; all distinct, so without the subtraction no tie
    lum = np.where(rng.uniform(size=300) < 0.3, rng.uniform(1.0, 5.0, size=300),
                   rng.uniform(0.0, 0.2, size=300)).astype(np.float32)
    jp, jw = j_compensate(jnp.asarray(pts), jnp.asarray(lum), max_points=120, mean_mult=mean_mult)
    tp, tw = compensate_pc(torch.from_numpy(pts), torch.from_numpy(lum), max_points=120, mean_mult=mean_mult)
    assert tp.shape == (120, 3) and tw.shape == (120,)
    np.testing.assert_allclose(_multiset(tp.numpy(), tw.numpy()), _multiset(jp, jw), rtol=1e-6, atol=0.0)
    assert int((tw == 0).sum()) == int((np.asarray(jw) == 0).sum())
    for a, b in ((tw.numpy() @ tp.numpy(), np.asarray(jw) @ np.asarray(jp)),
                 (tw.numpy() @ tp.numpy() ** 2, np.asarray(jw) @ np.asarray(jp) ** 2)):
        np.testing.assert_allclose(a, b, rtol=1e-5)


def _two_blobs():
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    a = jax.random.normal(k1, (256, 3)) * 0.05 + jnp.array([1.0, 0.0, 0.0])
    b = jax.random.normal(k2, (256, 3)) * 0.05 + jnp.array([-1.0, 0.0, 0.0])
    w = jnp.asarray(np.random.default_rng(16).uniform(0.0, 1.0, size=512).astype(np.float32))
    return jnp.concatenate([a, b]), w


def _j_seeds(key, w, k):
    """The seed indices fit_spherical_gmm draws from `key`."""
    wn = w / jnp.maximum(jnp.sum(w), 1e-12)
    return np.asarray(jax.random.categorical(key, jnp.log(wn + 1e-12), shape=(k,)))


@pytest.mark.parametrize("n_clusters", [4, 16])
def test_gmm_em_matches_jax_from_its_seeds(n_clusters):
    """Weighted EM from the seeds JAX drew: means, mixture weights and stds
    (measured: means within 3.4e-5, weights and stds within 2e-6)."""
    pts, w = _two_blobs()
    key = jax.random.PRNGKey(3)
    ref = j_fit(key, pts, w, n_clusters=n_clusters, n_iters=30)
    out = fit_spherical_gmm(None, torch.from_numpy(np.array(pts)), torch.from_numpy(np.array(w)),
                            n_clusters=n_clusters, n_iters=30,
                            seed_idx=torch.from_numpy(_j_seeds(key, w, n_clusters)))
    for a, b in zip(out, ref):
        _close(a, b, rtol=1e-4, atol=1e-5)
    g = torch.Generator().manual_seed(0)
    means, pis, stds = fit_spherical_gmm(g, torch.from_numpy(np.array(pts)),
                                         torch.from_numpy(np.array(w)), n_clusters=4, n_iters=40)
    top2 = means[torch.argsort(-pis)[:2], 0].sort().values
    torch.testing.assert_close(top2, torch.tensor([-1.0, 1.0]), rtol=0.0, atol=0.15)
    assert abs(float(pis.sum()) - 1.0) < 1e-4 and bool((stds > 0).all())


def _mixture():
    rng = np.random.default_rng(17)
    pos = rng.uniform(0.0, 1.0, size=(5, 3)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=5).astype(np.float32)
    std = rng.uniform(0.05, 0.6, size=5).astype(np.float32)
    return (JVMF(positions=jnp.asarray(pos), weights=jnp.asarray(w), stds=jnp.asarray(std)),
            VMFMixture(positions=torch.from_numpy(pos), weights=torch.from_numpy(w), stds=torch.from_numpy(std)))


def test_vmf_mixture_pdf_and_sample_match_jax():
    """pdf at random directions; sample from JAX's own draws (its lobe
    indices, handed to the port as a uniform inside that lobe's CDF
    interval, and its two angle uniforms)."""
    jv, tv = _mixture()
    rng = np.random.default_rng(18)
    x = rng.uniform(0.3, 0.7, size=(200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tv.pdf(torch.from_numpy(x), torch.from_numpy(d)), jv.pdf(jnp.asarray(x), jnp.asarray(d)),
           rtol=1e-5, atol=1e-7)
    key = jax.random.PRNGKey(19)
    jd, jpdf = jv.sample(key, jnp.asarray(x))
    k1, k2, k3 = jax.random.split(key, 3)
    wn = jv.weights / jnp.maximum(jnp.sum(jv.weights), 1e-12)
    comp = np.asarray(jax.random.categorical(k1, jnp.log(wn + 1e-12)[None, :].repeat(200, 0)))
    cdf = np.cumsum(np.asarray(tv.weights / tv.weights.sum(), np.float64))
    lo = np.concatenate([[0.0], cdf[:-1]])
    u_lobe = torch.from_numpy(((lo + cdf) / 2.0)[comp].astype(np.float32))
    u = torch.from_numpy(np.asarray(jax.random.uniform(k2, (200,))))
    u_phi = torch.from_numpy(np.asarray(jax.random.uniform(k3, (200,))))
    td, tpdf = tv.sample(torch.from_numpy(x), uniforms=(u_lobe, u, u_phi))
    _close(td, jd, rtol=0.0, atol=2e-5)
    _close(tpdf, jpdf, rtol=1e-4, atol=1e-7)
    gd, gpdf = tv.sample(torch.from_numpy(x), torch.Generator().manual_seed(0))
    torch.testing.assert_close(gd.norm(dim=-1), torch.ones(200), rtol=0.0, atol=1e-5)
    assert bool((gpdf > 0).all())


def test_vmf_guiding_build_matches_jax():
    """VMFGuiding.build end to end on a ring of cameras (the light probes at
    INF_FAR, compensation, EM), from the seeds JAX drew: each JAX seed is
    handed to the port as the port's index of the same kept point. The
    mixture inherits the INF_FAR probes' differences (see above): held at
    2e-3 absolute on the positions, 3e-3 on the weights and 5e-3 relative
    on the stds (measured 5.5e-4, 8.1e-4 and 1.0e-3)."""
    jm, params, pm = lit_pair()
    jc, tc = _cameras(size=32)
    key = jax.random.PRNGKey(20)
    box = np.asarray(OBJECT_BOX, np.float32)
    ref = JVMFGuiding(n_clusters=4).build(key, jm, params, jc, object_aabb=jnp.asarray(box))
    # JAX's seeds, as kept points
    jpc = j_extract(jm, params, jc, object_aabb=jnp.asarray(box), downscale=4)
    jpts, jw = j_compensate(jpc["points"], jpc["luminance"], 32768)
    jseed_pts = np.asarray(coords_j(jpts))[_j_seeds(key, jw, 4)]
    tpc = extract_light_point_cloud(pm, tc, object_aabb=torch.from_numpy(box), downscale=4)
    tpts, _ = compensate_pc(tpc["points"], tpc["luminance"], 32768)
    tunit = coords.world_to_unit(tpts, 1.0).numpy()
    seed_idx = torch.tensor([int(np.argmin(np.abs(tunit - p).sum(axis=1))) for p in jseed_pts])
    np.testing.assert_allclose(tunit[seed_idx.numpy()], jseed_pts, rtol=0.0, atol=1e-6)
    out = VMFGuiding(n_clusters=4).build(None, pm, tc, torch.from_numpy(box), seed_idx=seed_idx)
    assert isinstance(out, VMFMixture)
    _close(out.positions, ref.positions, rtol=0.0, atol=2e-3)
    _close(out.weights, ref.weights, rtol=0.0, atol=3e-3)
    _close(out.stds, ref.stds, rtol=5e-3, atol=1e-6)
    assert VMFGuiding().should_rebuild(20) and not VMFGuiding().should_rebuild(21)


def coords_j(pts):
    """World -> unit at scene_scale 1, the JAX package's coords."""
    from nerf_emitter_tpu.utils import coords as jcoords

    return jcoords.world_to_unit(pts, 1.0)
