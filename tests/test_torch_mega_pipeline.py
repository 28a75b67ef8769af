"""K5, the emitter query's forward, against the JAX package: the port's
`make_mega_radiance_query` against the JAX builder's pipelined megakernel
(Pallas interpret mode on the CPU) on one set of weights (one JAX
`model.init` carried across by the bridge) and numpy-made rays; K5
against K4 on K3's bins; the query deaf to the reference's two switches;
and the ray pad table the kernels' row blocks take.

On the CPU the K5 wrapper runs its plain twin, the proposal twin followed
by the field/composite twin."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.rays import RayBundle as JRayBundle
from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.ops.mega_query import make_mega_radiance_query as j_mega_query
from nerf_emitter_tpu_torch.bridge import load_flax_params
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops import fused_field as tff
from nerf_emitter_tpu_torch.ops import mega_query as tmq
from nerf_emitter_tpu_torch.parallel.mesh import fill_rows

torch.set_num_threads(1)

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
CFG = dict(num_nerf_samples=6, num_proposal_samples=(12, 8), num_cameras=4, appearance_embedding_dim=8,
           implementation="freq")
ENV = ("NERF_EMITTER_MEGA_PIPELINED", "NERF_EMITTER_MEGA_MXU_CHUNK")


def _rays_np(n, seed):
    """The JAX suite's mega-query rays: from the origin, unit directions,
    near 0.05, far 3, camera 1."""
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(origins=np.zeros((n, 3), np.float32), directions=d,
                pixel_area=np.full((n, 1), 1e-4, np.float32), nears=np.full((n, 1), 0.05, np.float32),
                fars=np.full((n, 1), 3.0, np.float32), camera_indices=np.ones((n, 1), np.int32))


def _both(r):
    jr = JRayBundle(**{k: jnp.asarray(v) for k, v in r.items()})
    tr = RayBundle(**{k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                      for k, v in r.items()})
    return jr, tr


@functools.lru_cache(maxsize=1)
def _models():
    """The same weights in both packages (one JAX model.init)."""
    jm = JModel(aabb=AABB, **CFG)
    jr, _ = _both(_rays_np(4, seed=0))
    params = jm.init(jax.random.PRNGKey(1), jr)
    pm = NerfactoModel(AABB, device="cpu", **CFG)
    load_flax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm


def _pair(n):
    """Both packages' models and n rays in both."""
    jm, params, pm = _models()
    jr, tr = _both(_rays_np(n, seed=n))
    return jm, params, jr, pm, tr


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _kernel_args(pm, tr, n_pad=None):
    """The rays of tr in the kernels' (3, N) / (1, N) layout (padded to
    n_pad rows with RAY_PADS), and the K3 inputs, K4 inputs and keyword
    arguments the query hands its kernels: camera 1's appearance vector,
    f-major first-layer rows."""
    n_pad = n_pad or tr.origins.shape[0]
    rows = [fill_rows(getattr(tr, k), n_pad, tmq.RAY_PADS[k]).T.contiguous()
            for k in ("origins", "directions", "nears", "fars")]
    p = tff.named_params(pm)
    (ws0, bs0), (ws1, bs1) = tff._mlp_params(p, "proposal_0.mlp"), tff._mlp_params(p, "proposal_1.mlp")
    bws, bbs = tff._mlp_params(p, "field.base_mlp")
    hws, hbs = tff._mlp_params(p, "field.head_mlp")
    props = (tff.permute_first(ws0, 4), bs0, tff.permute_first(ws1, 6), bs1)
    field = (p["field.appearance_embedding.weight"][1], tff.permute_first(bws, 10), bbs, hws, hbs)
    box = dict(aabb_lo=(-1.5,) * 3, aabb_inv_ext=(1 / 3,) * 3, disable_box=None, avg_density=1.0)
    k3 = dict(s0=12, s1=8, s2=6, freqs0=4, freqs1=6, **box)
    k4 = dict(s2=6, freqs=10, hdr=True, rgb_bias=0.0, **box)
    return rows, props, field, k3, k4


@pytest.mark.parametrize("n", [100, 300, 1, 128, 129],
                         ids=["one_tile", "three_tiles", "one_ray", "exact_tile", "tile_plus_one"])
def test_pipelined_query_matches_jax_pipelined(n, clean_env):
    """The port's K5 query against the JAX pipelined megakernel at one ray,
    at one and three padded 128-ray tiles, at an exact tile and at a tile
    plus one ray, at the JAX suite's mega bar (rtol 3e-2, atol 1e-3): the
    TPU kernel's inverse CDF is a telescoped ramp sum, the port's a CDF
    walk, and the two differ by ~1e-4 of the spacing range."""
    jm, params, jr, pm, tr = _pair(n)
    ref = j_mega_query(jm, pipelined=True)(params, jr, camera_index=jnp.int32(1))
    query = tmq.make_mega_radiance_query(pm, device="cpu")
    out = query(pm, tr, camera_index=1)
    assert out.shape == (n, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=3e-2, atol=1e-3)


def test_pipelined_equals_two_kernel_on_the_cpu(clean_env):
    """The query's answer at 150 rays (two tiles, the second part-filled)
    is K4's on K3's bins, bit for bit, on the rows the query pads; and
    gradients through the query (the staged recompute) are finite."""
    _, _, _, pm, tr = _pair(150)
    query = tmq.make_mega_radiance_query(pm, device="cpu")
    rows, props, field, k3, k4 = _kernel_args(pm, tr, n_pad=2 * tmq.TILE_RAYS)
    with torch.no_grad():
        two = tmq.field_composite(tmq.proposal_bins(*rows, *props, **k3), *rows, *field, **k4)
        torch.testing.assert_close(query(pm, tr, camera_index=1), two[:, :150].T, rtol=0.0, atol=0.0)
    o = tr.origins.clone().requires_grad_()
    g = torch.autograd.grad(query(pm, tr.replace(origins=o), camera_index=1).sum(), o)[0]
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def _spy(monkeypatch):
    """Record which kernel wrappers a query's forward calls."""
    calls = []
    for name in ("mega_pipeline", "proposal_bins", "field_composite"):
        real = getattr(tmq, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tmq, name, spy)
    return calls


@pytest.mark.parametrize("env", [{"NERF_EMITTER_MEGA_PIPELINED": "0"}, {"NERF_EMITTER_MEGA_MXU_CHUNK": "0"},
                                 {"NERF_EMITTER_MEGA_MXU_CHUNK": "two"}],
                         ids=["pipelined_off", "chunk_zero", "chunk_word"])
def test_query_ignores_the_reference_switches(env, clean_env):
    """The JAX builder's two switches select nothing in the port: built and
    called under either, the query's forward is one K5 call, never K3 or
    K4, and its answer is a clean environment's, bit for bit."""
    _, _, _, pm, tr = _pair(40)
    with torch.no_grad():
        ref = tmq.make_mega_radiance_query(pm, device="cpu")(pm, tr, camera_index=1)
    for k, v in env.items():
        clean_env.setenv(k, v)
    query = tmq.make_mega_radiance_query(pm, device="cpu")
    calls = _spy(clean_env)
    with torch.no_grad():
        out = query(pm, tr, camera_index=1)
    assert calls == ["mega_pipeline"]
    torch.testing.assert_close(out, ref, rtol=0.0, atol=0.0)


def test_mega_pipeline_twin_is_k3_then_k4():
    """The K5 twin with its aux output equals the K4 twin on the K3 twin's
    bins: the TPU kernel's per-tile math is that of the two-kernel path."""
    _, _, _, pm, tr = _pair(128)
    rows, props, (emb, *field), k3, k4 = _kernel_args(pm, tr)
    with torch.no_grad():
        rgb, aux = tmq.mega_pipeline(*rows, emb, *props, *field, **k3, freqs=10, hdr=True, rgb_bias=0.0,
                                     with_aux=True)
        sbins = tmq.proposal_bins(*rows, *props, **k3)
        rgb2, aux2 = tmq.field_composite(sbins, *rows, emb, *field, **k4, with_aux=True)
    torch.testing.assert_close(rgb, rgb2, rtol=0.0, atol=0.0)
    torch.testing.assert_close(aux, aux2, rtol=0.0, atol=0.0)


# the JAX package's pad values (nerf_emitter_tpu/pipelines/nerf_emitter.py:70-76,
# ops/mega_query.py:623-626); it drops `valid`, which the port fills with the last row
JAX_PADS = {"origins": 0.0, "directions": 1.0, "pixel_area": 1e-4, "nears": 0.1, "fars": 0.2, "camera_indices": 0,
            "valid": None}


@pytest.mark.parametrize("name", [f.name for f in dataclasses.fields(RayBundle)])
def test_ray_pads_fill_every_field(name):
    """RAY_PADS holds the JAX package's value for every field of
    RayBundle, and fill_rows pads a k-row block of the field to m rows:
    the k rows kept, the rest that value, or the last row repeated where
    it is None (`valid`)."""
    k, m = 5, 8
    width, dtype = {"origins": (3, torch.float32), "directions": (3, torch.float32),
                    "camera_indices": (1, torch.long), "valid": (1, torch.bool)}.get(name, (1, torch.float32))
    x = (torch.arange(k * width).reshape(k, width) + 2).to(dtype)
    assert tmq.RAY_PADS[name] == JAX_PADS[name]
    out = fill_rows(x, m, tmq.RAY_PADS[name])
    assert out.shape == (m, width) and out.dtype == dtype
    assert torch.equal(out[:k], x)
    fill = JAX_PADS[name]
    want = x[-1:].expand(m - k, width) if fill is None else torch.full((m - k, width), fill, dtype=dtype)
    assert torch.equal(out[k:], want)
