"""The port's hash grid (`hash_encode`), the `hash` fields and model, and
the emitter closure's fused gate, against the JAX package on one set of
weights carried across by the bridge.

The hash model is the tiny NeRF of tests/test_distill.py (aabb +-1,
proposals (12, 8), 8 field samples, 2^12 tables, max_res 128, 6 cameras,
a 4-d appearance embedding)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.rays import RayBundle as JRayBundle
from nerf_emitter_tpu.fields.encodings import HashGridSpec as JSpec
from nerf_emitter_tpu.fields.encodings import hash_encode as j_hash_encode
from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.pipelines.nerf_emitter import make_nerf_emitter_fn as j_emitter
from nerf_emitter_tpu_torch.bridge import load_flax_params
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.fields.encodings import HashGridSpec, hash_encode
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops.fused_field import make_fused_radiance_query
from nerf_emitter_tpu_torch.ops.mega_query import make_mega_radiance_query
from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn, serves_kernel_query

torch.set_num_threads(1)

AABB = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
OBJECT_BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
TINY = dict(num_nerf_samples=8, num_proposal_samples=(12, 8), log2_hashmap_size=12, max_res=128,
            num_cameras=6, appearance_embedding_dim=4)
# The f32 bar of the JAX suite. Both sides run flax Dense(dtype=bf16)
# arithmetic on the same features; measured: the fields within 6e-8, the
# model's outputs within 2e-6 of their largest value.
RTOL, ATOL = 1e-5, 1e-6


def _rays_np(n=16, seed=0, far=3.0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(
        origins=rng.uniform(-0.3, 0.3, size=(n, 3)).astype(np.float32), directions=d,
        pixel_area=np.full((n, 1), 1e-4, np.float32), nears=np.full((n, 1), 0.05, np.float32),
        fars=np.full((n, 1), far, np.float32),
        camera_indices=rng.integers(0, 6, size=(n, 1)).astype(np.int32),
    )


def _both(r):
    jr = JRayBundle(**{k: jnp.asarray(v) for k, v in r.items()})
    tr = RayBundle(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
                      for k, v in r.items()})
    return jr, tr


def hash_pair(seed=0, **over):
    """A JAX hash model and the port's, with the same weights."""
    cfg = dict(TINY, **over)
    jm = JModel(aabb=AABB, **cfg)
    jr, _ = _both(_rays_np(4))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jr)
    pm = NerfactoModel(AABB, device="cpu", **cfg)
    load_flax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm


def _positions(n, seed):
    """Uniform in [0, 1]^3 with rows on the 0 and 1 faces and corners."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    pos[:16] = np.where(rng.uniform(size=(16, 3)) < 0.5, 0.0, 1.0)
    pos[16:24, 0] = 1.0
    pos[24:32, 2] = 0.0
    return pos


# (levels, log2 table, min res, max res): one dense level whose far corner at
# pos == 1 lies past the table; dense and hashed levels; hashed levels only
SPECS = {"dense": (1, 12, 4, 4), "dense_and_hashed": (4, 12, 4, 32), "hashed": (16, 12, 16, 2048)}


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_encode_matches_jax(name):
    """Same table rows and weights as the JAX grid. The dense levels agree
    to an ulp (measured 1.2e-7); at non-power-of-two resolutions XLA contracts
    x s - floor(x s) into a fused multiply-add, which moves a trilinear
    weight by up to ulp(x s) ~ 1e-4 at res 1482: with table values of
    order 1 the hashed levels are held at atol 2e-4 (a wrong table row would
    be off by ~1)."""
    levels, log2, lo, hi = SPECS[name]
    jspec = JSpec(num_levels=levels, log2_hashmap_size=log2, min_res=lo, max_res=hi)
    spec = HashGridSpec(levels, 2, log2, lo, hi)
    assert spec.resolutions == jspec.resolutions and spec.offsets == jspec.offsets
    table = np.random.default_rng(1).uniform(-1.0, 1.0, size=(spec.total_size, 2)).astype(np.float32)
    pos = _positions(400, seed=2)
    ref = np.asarray(j_hash_encode(jnp.asarray(table), jnp.asarray(pos), jspec))
    out = hash_encode(torch.from_numpy(table), torch.from_numpy(pos), spec).numpy()
    assert out.shape == (400, spec.out_dim)
    np.testing.assert_allclose(out, ref, rtol=0.0, atol=1e-6 if name == "dense" else 2e-4)


def test_hash_encode_corner_is_the_table_row():
    """At a grid corner of a dense level the encoding is that row."""
    spec = HashGridSpec(1, 2, 12, 4, 4)
    table = torch.randn(spec.total_size, 2)
    out = hash_encode(table, torch.tensor([[0.25, 0.5, 0.75]]), spec)
    torch.testing.assert_close(out[0], table[1 + 5 * (2 + 5 * 3)], rtol=0.0, atol=1e-6)


@pytest.mark.parametrize("name", list(SPECS))
def test_hash_encode_table_gradient_matches_jax(name):
    """d sum(enc^2) / d table: the scatter-add transpose of the gather, as
    jax.grad builds it (face rows included, where a clamped corner gets 0)."""
    levels, log2, lo, hi = SPECS[name]
    jspec = JSpec(num_levels=levels, log2_hashmap_size=log2, min_res=lo, max_res=hi)
    spec = HashGridSpec(levels, 2, log2, lo, hi)
    table = np.random.default_rng(3).uniform(-1.0, 1.0, size=(spec.total_size, 2)).astype(np.float32)
    pos = _positions(200, seed=4)
    ref = np.asarray(jax.grad(lambda t: jnp.sum(j_hash_encode(t, jnp.asarray(pos), jspec) ** 2))(
        jnp.asarray(table)))
    t = torch.from_numpy(table).requires_grad_()
    (hash_encode(t, torch.from_numpy(pos), spec) ** 2).sum().backward()
    assert float(np.abs(ref).sum()) > 0.0
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0.0, atol=1e-6 if name == "dense" else 1e-3)


def test_bridge_loads_the_hash_tables():
    _, params, pm = hash_pair()
    tree = params["params"]
    for name in ("field", "proposal_0", "proposal_1"):
        np.testing.assert_array_equal(getattr(pm, name).hash_table.detach().numpy(),
                                      np.asarray(tree[name]["hash_table"]))
    assert pm.field.hash_table.shape == (pm.field.grid_spec.total_size, 2)
    bad = jax.tree.map(np.asarray, params)["params"]
    del bad["proposal_1"]["hash_table"]
    with pytest.raises(KeyError, match="proposal_1/hash_table"):
        load_flax_params(pm, bad)
    bad = jax.tree.map(np.asarray, params)["params"]
    bad["field"]["hash_table"] = bad["field"]["hash_table"][:-1]
    with pytest.raises(ValueError, match="field/hash_table"):
        load_flax_params(pm, bad)


@pytest.mark.parametrize("box", [None, OBJECT_BOX], ids=["nobox", "carveout"])
def test_hash_fields_match_jax(box):
    """Both hash fields' densities, geo features and colours against
    flax on bridged tables, at positions inside and outside the scene box."""
    jm, params, pm = hash_pair()
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = (np.arange(64, dtype=np.int32) % 6)[:, None]
    jbox = None if box is None else jnp.asarray(box)
    kw = dict(disable_aabb_on=box is not None)
    jd, jg = jm.apply(params, jnp.asarray(pos), method=lambda m, x: m.field.get_density(
        x, disable_aabb=jbox, **kw))
    td, tg = pm.field.get_density(torch.from_numpy(pos), disable_aabb=box, **kw)
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL)
    jrgb = jm.apply(params, jg, jnp.asarray(dirs), jnp.asarray(cams),
                    method=lambda m, g, d, c: m.field.get_rgb(g, d, c))
    trgb = pm.field.get_rgb(tg, torch.from_numpy(dirs), torch.from_numpy(cams.astype(np.int64)))
    np.testing.assert_allclose(trgb.detach().numpy(), np.asarray(jrgb), rtol=RTOL, atol=ATOL)
    for lvl in (0, 1):
        jp = jm.apply(params, jnp.asarray(pos), method=lambda m, x: m.proposal_networks[lvl](
            x, disable_aabb=jbox, **kw))
        tp = pm.proposal_networks[lvl](torch.from_numpy(pos), disable_aabb=box, **kw)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("box", [None, OBJECT_BOX], ids=["nobox", "carveout"])
def test_hash_model_eval_outputs_match_jax(box):
    jm, params, pm = hash_pair()
    jr, tr = _both(_rays_np(32, seed=6))
    jbox = None if box is None else jnp.asarray(box)
    ref = jm.apply(params, jr, train=False, disable_aabb=jbox, disable_aabb_on=box is not None)
    out = pm(tr, disable_aabb=box, disable_aabb_on=box is not None)
    for k in ("rgb", "accumulation", "depth"):
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_hash_emitter_matches_jax():
    """make_nerf_emitter_fn on a hash model: the model's forward serves it
    in both packages (the gate), with the carve-out, far=4."""
    jm, params, pm = hash_pair()
    rng = np.random.default_rng(7)
    x = rng.uniform(0.35, 0.65, size=(48, 3)).astype(np.float32)
    d = rng.normal(size=(48, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = j_emitter(jm, 1.0, jnp.asarray(OBJECT_BOX), far=4.0)(params, camera_index=2)(
        jnp.asarray(x), jnp.asarray(d))
    out = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, far=4.0)(camera_index=2)(
        torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("detach_nerf", [True, False], ids=["frozen", "trained"])
def test_hash_emitter_vjp_matches_jax(monkeypatch, detach_nerf):
    """make_nerf_emitter_fn on a hash model through its chunked route
    (`_ChunkedQuery`: RECOMPUTE_RAYS at 16, 45 rays, so three chunks and a
    padded one), with the NeRF frozen and trained: the radiance and the
    gradients of x and d given a cotangent against jax.vjp through the JAX
    emitter (its parameters held, not differentiated), at the file's bar."""
    from nerf_emitter_tpu_torch.ops import mega_query

    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", 16)
    jm, params, pm = hash_pair()
    rng = np.random.default_rng(17)
    x = rng.uniform(0.35, 0.65, size=(45, 3)).astype(np.float32)
    d = rng.normal(size=(45, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g = rng.uniform(size=(45, 3)).astype(np.float32)
    ref, vjp = jax.vjp(j_emitter(jm, 1.0, jnp.asarray(OBJECT_BOX), far=4.0)(params, camera_index=2),
                       jnp.asarray(x), jnp.asarray(d))
    tx, td = torch.from_numpy(x).requires_grad_(), torch.from_numpy(d).requires_grad_()
    out = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, far=4.0, detach_nerf=detach_nerf)(camera_index=2)(tx, td)
    got = torch.autograd.grad(out, (tx, td), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    for a, b in zip(got, vjp(jnp.asarray(g))):
        assert np.abs(np.asarray(b)).max() > 0
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("implementation", ["freq", "hash"])
@pytest.mark.parametrize("fake_contraction", [True, False], ids=["fake", "nonlinear"])
def test_fused_gate(implementation, fake_contraction):
    """The kernel query serves the emitter only for freq with the fake
    contraction on CUDA, and only when asked; the decision reads the
    configuration alone (a stand-in model whose device says CUDA)."""
    model = types.SimpleNamespace(implementation=implementation, use_fake_contraction=fake_contraction,
                                  device=torch.device("cuda"))
    want = implementation == "freq" and fake_contraction
    assert serves_kernel_query(model, True) is want
    assert serves_kernel_query(model, False) is False
    model.device = torch.device("cpu")
    assert serves_kernel_query(model, True) is False


def test_kernel_query_builders_refuse_a_hash_model():
    """The kernels compute the freq field only: building a kernel query for
    a hash model raises; the emitter closure never builds one (the gate)."""
    pm = NerfactoModel(AABB, device="cpu", **TINY)
    for build in (make_fused_radiance_query, make_mega_radiance_query):
        with pytest.raises(ValueError, match="freq-only"):
            build(pm, device="cpu")
    fn = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX)(camera_index=1)
    x = torch.full((4, 3), 0.5)
    d = torch.nn.functional.normalize(torch.randn(4, 3), dim=-1)
    out = fn(x, d)
    assert out.shape == (4, 3) and torch.isfinite(out).all()
