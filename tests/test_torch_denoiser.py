"""The port's learned denoiser (renderer/learned_denoise.py) against the
JAX package: the kernel predictor and the denoised image on bridged
weights (flax HWIO kernels as OIHW), one noise2noise step's loss and
gradients against jax.value_and_grad, a 5-step fit from JAX's init against
JAX's fit (by the denoised output: Adam turns roundoff in near-zero
gradients into +-lr steps, so weights are the wrong thing to compare), the
convex-combination and odd-shape cases of tests/test_denoiser.py, the
noise2noise contract from a torch.Generator, and the pipeline's
fit_scene_denoiser and render_camera_outputs(denoise="learned") on a tiny
CPU pipeline. Tolerances: apply rtol 1e-5 / atol 1e-5; the loss, the
gradients and the 5-step fit rtol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.renderer import learned_denoise as jld
from nerf_emitter_tpu_torch.bridge import load_denoiser_params
from nerf_emitter_tpu_torch.renderer import learned_denoise as tld

torch.set_num_threads(1)

CFG = tld.DenoiserConfig()  # the shipped widths
TINY = tld.DenoiserConfig(radius=1, hidden=8, depth=2, fit_steps=80, lr=5e-3)  # tests/test_denoiser.py's


def _clean(h=32, w=32) -> np.ndarray:
    """tests/test_denoiser.py's clean image: smooth bands and an HDR hot
    spot of +25 at [8:12, 8:12]."""
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    zero = np.zeros((h, w), np.float32)
    base = np.stack([zero + 0.5 + 0.4 * np.sin(6 * x), zero + 0.3 + 0.3 * y * x, zero + 0.2 + 0.5 * y], axis=-1)
    base[8:12, 8:12] += 25.0
    return base


def _inputs(h, w, seed=0):
    """(noisy rgb, normal, depth) numpy at h x w."""
    rng = np.random.default_rng(seed)
    rgb = (_clean(h, w) * (1.0 + 0.25 * rng.standard_normal((h, w, 3)))).astype(np.float32)
    normal = rng.standard_normal((h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    depth = (1.0 + rng.uniform(0.0, 1.0, (h, w, 1))).astype(np.float32)
    return rgb, normal, depth


def _pair(config, key=0):
    """JAX's init_denoiser params and the port's predictor bridged from them."""
    jparams = jld.init_denoiser(jax.random.PRNGKey(key), jld.DenoiserConfig(**dataclasses.asdict(config)))
    module = tld.KernelPredictor(config.radius, config.hidden, config.depth, device="cpu")
    load_denoiser_params(module, jax.tree.map(np.asarray, jparams))
    return jparams, module


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("shape", [(16, 16), (9, 13)])
@pytest.mark.parametrize("guides", [True, False])
def test_apply_matches_jax(shape, guides):
    rgb, normal, depth = _inputs(*shape)
    if not guides:
        normal = depth = None
    jparams, module = _pair(CFG)
    jcfg = jld.DenoiserConfig()
    want = jld.apply_denoiser(jparams, _j(rgb), _j(normal), _j(depth), jcfg)
    feats = tld._features(_t(rgb), _t(normal), _t(depth))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jld._features(_j(rgb), _j(normal), _j(depth))),
                               rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        got = tld.apply_denoiser(module, _t(rgb), _t(normal), _t(depth), CFG)
    assert got.shape == rgb.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_window_stack_and_percentile_match_jax():
    """The edge-clamped window equals JAX's bit for bit; the percentile
    (kthvalue, linear interpolation) equals jnp.percentile, and numpy's
    on a 4097^2 depth buffer, past torch.quantile's 2^24 elements."""
    img = np.random.default_rng(1).standard_normal((7, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tld._window_stack(_t(img), 2).numpy(), np.asarray(jld._window_stack(_j(img), 2)))
    depth = np.random.default_rng(2).uniform(1.0, 3.0, (9, 13, 1)).astype(np.float32)
    for q in (5.0, 95.0, 0.0, 100.0):
        np.testing.assert_allclose(float(tld._percentile(_t(depth), q)), float(jnp.percentile(_j(depth), q)),
                                   rtol=1e-6)
    big = torch.rand(4097 * 4097, generator=torch.Generator().manual_seed(0))
    want = np.percentile(big.double().numpy(), 95.0)
    np.testing.assert_allclose(float(tld._percentile(big, 95.0)), want, rtol=1e-6)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(big, 0.95)


def test_apply_is_convex_combination():
    """tests/test_denoiser.py's case: a constant image comes back within
    1e-5 relative; every output pixel lies inside the image's range."""
    module = tld.init_denoiser(torch.Generator().manual_seed(0), TINY)
    with torch.no_grad():
        out = tld.apply_denoiser(module, torch.full((16, 16, 3), 3.7), config=TINY)
        np.testing.assert_allclose(out.numpy(), 3.7, rtol=1e-5)
        clean = torch.from_numpy(_clean(16, 16))
        out = tld.apply_denoiser(module, clean, config=TINY)
    assert float(out.min()) >= float(clean.min()) - 1e-4
    assert float(out.max()) <= float(clean.max()) + 1e-4


@pytest.mark.parametrize("shape", [(9, 13), (16, 16)])
def test_apply_odd_shapes(shape):
    module = tld.init_denoiser(torch.Generator().manual_seed(0), TINY)
    img = torch.rand(shape + (3,), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = tld.apply_denoiser(module, img, config=TINY)
    assert out.shape == img.shape and bool(torch.isfinite(out).all())


def test_init_matches_flax_statistics():
    """init_denoiser draws flax's lecun_normal (truncated at 2 sigma,
    variance 1 / fan_in) and zero biases: the layer shapes equal the
    bridged tree's, and each kernel's std is within 10% of flax's."""
    jparams, bridged = _pair(CFG)
    module = tld.init_denoiser(torch.Generator().manual_seed(0), CFG)
    for (name, p), (_, q) in zip(module.named_parameters(), bridged.named_parameters()):
        assert p.shape == q.shape, name
        if name.endswith("bias"):
            assert not p.any()
        else:
            np.testing.assert_allclose(float(p.detach().std()), float(q.detach().std()), rtol=0.1)


def test_step_loss_and_gradients_match_jax():
    """One step's noise2noise loss and its gradients (flax's HWIO kernels
    against the port's OIHW) at JAX's init."""
    a, normal, depth = _inputs(12, 10, seed=4)
    b = _inputs(12, 10, seed=5)[0]
    jparams, module = _pair(CFG)
    jcfg = jld.DenoiserConfig()

    def rel_l1(pred, target):
        return jnp.mean(jnp.abs(pred - target) / (jax.lax.stop_gradient(jnp.abs(target)) + 1e-2))

    def loss_fn(p):
        fa = jld.apply_denoiser(p, _j(a), _j(normal), _j(depth), jcfg)
        fb = jld.apply_denoiser(p, _j(b), _j(normal), _j(depth), jcfg)
        return rel_l1(fa, _j(b)) + rel_l1(fb, _j(a))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    loss = tld.denoiser_loss(module, _t(a), _t(b), _t(normal), _t(depth), CFG)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    layers = {f"conv_{i}": c for i, c in enumerate(module.convs)} | {"head": module.head}
    for name, conv in layers.items():
        g = jgrads["params"][name]
        np.testing.assert_allclose(conv.weight.grad.numpy(), np.asarray(g["kernel"]).transpose(3, 2, 0, 1),
                                   rtol=1e-4, atol=1e-4 * float(np.abs(g["kernel"]).max()))
        np.testing.assert_allclose(conv.bias.grad.numpy(), np.asarray(g["bias"]), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g["bias"]).max()))


def test_five_step_fit_matches_jax():
    """fit_denoiser_from JAX's init_denoiser(key), against JAX's
    fit_denoiser(key, ...), 5 steps over two pairs: the final loss and the
    denoised image agree within rtol 1e-4."""
    cfg = dataclasses.replace(CFG, fit_steps=5)
    pairs = []
    for s in (6, 8):
        a, normal, depth = _inputs(16, 16, seed=s)
        pairs.append((a, _inputs(16, 16, seed=s + 1)[0], normal, depth))
    jp, jloss = jld.fit_denoiser(jax.random.PRNGKey(3), [tuple(map(_j, p)) for p in pairs],
                                 jld.DenoiserConfig(**dataclasses.asdict(cfg)))
    _, module = _pair(CFG, key=3)
    module, loss = tld.fit_denoiser_from(module, [tuple(map(_t, p)) for p in pairs], cfg)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    rgb, normal, depth = _inputs(16, 16, seed=20)
    want = jld.apply_denoiser(jp, _j(rgb), _j(normal), _j(depth), jld.DenoiserConfig())
    with torch.no_grad():
        got = tld.apply_denoiser(module, _t(rgb), _t(normal), _t(depth), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_noise2noise_fit_denoises_from_a_generator():
    """tests/test_denoiser.py's contract with torch's draws: fitted on
    three pairs of noisy buffers only, the denoised image's relative error
    is below 0.75x the noisy input's, and the hot spot survives above 5."""
    g = torch.Generator().manual_seed(1)
    clean = torch.from_numpy(_clean())

    def noisy():
        return clean * (1.0 + 0.25 * torch.randn(clean.shape, generator=g))

    normal = torch.zeros(clean.shape)
    depth = torch.linspace(1, 2, clean.shape[0])[:, None, None] * torch.ones(clean.shape[:2] + (1,))
    pairs = [(noisy(), noisy(), normal, depth) for _ in range(3)]
    module, loss = tld.fit_denoiser(torch.Generator().manual_seed(2), pairs, TINY)
    assert np.isfinite(loss)
    test_noisy = noisy()
    with torch.no_grad():
        out = tld.apply_denoiser(module, test_noisy, normal, depth, TINY)

    def rel_err(x):
        return float(torch.mean(torch.abs(x - clean) / (torch.abs(clean) + 1e-2)))

    assert rel_err(out) < 0.75 * rel_err(test_noisy), (rel_err(out), rel_err(test_noisy))
    assert float(out[8:12, 8:12].max()) > 5.0


def test_pipeline_learned_denoise(tmp_path, monkeypatch):
    """On a tiny CPU pipeline lit by an envmap (DenoiserConfig patched to
    20 steps of a narrow predictor, as the distillation's batch is patched
    elsewhere): fit_scene_denoiser caches the predictor and its config and
    returns a finite loss; the same generator fits the same weights;
    render_camera_outputs(denoise="learned") fits on first use from a
    generator seeded 17 and returns the denoiser applied to the noisy
    render with its normal and depth."""
    from nerf_emitter_tpu_torch.data.datamanager import ImageDataset
    from nerf_emitter_tpu_torch.engine import train_loop as TT
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
    from nerf_emitter_tpu_torch.pipelines import nerf_emitter as tne
    from nerf_emitter_tpu_torch.renderer import integrator as ti
    from nerf_emitter_tpu_torch.renderer import sphere_trace as tst
    from nerf_emitter_tpu_torch.renderer.optimize import get_opt_config
    from test_torch_pipeline import _ring

    small = tld.DenoiserConfig(radius=1, hidden=8, depth=2, fit_steps=20, lr=5e-3)
    monkeypatch.setattr(tne, "DenoiserConfig", lambda: small)
    np.save(tmp_path / "env.npy", np.full((8, 16, 3), 1.2, np.float32))
    _, cams = _ring(n=4, size=12)
    ds = ImageDataset(cameras=cams, images=torch.zeros(4, 12, 12, 3))
    model = NerfactoModel(((-1.0,) * 3, (1.0,) * 3), device="cpu", num_nerf_samples=8, num_proposal_samples=(8, 8),
                          log2_hashmap_size=8, max_res=16, num_cameras=4, appearance_embedding_dim=4)

    def pipeline():
        p = tne.NerfEmitterPipeline(
            tne.NerfEmitterPipelineConfig(takeover_step=0, guiding_type="env", env_path=str(tmp_path / "env.npy")),
            model, TT.TrainConfig(), get_opt_config("diffuse-12-relativel1-hqq"), ds,
            render_config=ti.RenderConfig(trace=tst.SphereTraceConfig(max_steps=16, t_max=3.0)))
        p.data_dir = tmp_path
        p.begin_takeover(torch.Generator().manual_seed(0))
        return p

    a = pipeline()
    loss = a.fit_scene_denoiser(torch.Generator().manual_seed(17), ds, n_views=2, fit_spp=2)
    assert np.isfinite(loss) and a._denoiser_config is small
    b = pipeline()
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    out = b.render_camera_outputs(ds, 1, gen, spp=2, denoise="learned")
    assert b._denoiser_config is small
    # fitted on first use from seed 17 at the defaults (3 views, fit_spp 8)
    c = pipeline()
    c.fit_scene_denoiser(torch.Generator().manual_seed(17), ds)
    for p, q in zip(b._denoiser_params.parameters(), c._denoiser_params.parameters()):
        assert torch.equal(p, q)
    noisy = b.render_camera_outputs(ds, 1, torch.Generator().manual_seed(0).set_state(state), spp=2)
    assert out["rgb"].shape == (12, 12, 3) and bool(torch.isfinite(out["rgb"]).all())
    want = tld.apply_denoiser(b._denoiser_params, noisy["rgb"], noisy["normal"], noisy["depth"], small)
    torch.testing.assert_close(out["rgb"], want, rtol=0, atol=0)
    assert not torch.equal(out["rgb"], noisy["rgb"])
    for k in ("depth", "normal", "accumulation"):
        torch.testing.assert_close(out[k], noisy[k], rtol=0, atol=0)
