"""K5, the pipelined emitter query, against the JAX package: the port's
`make_mega_radiance_query(pipelined=True)` against the JAX builder's
pipelined megakernel (Pallas interpret mode on the CPU) on one set of
weights (one JAX `model.init` carried across by the bridge) and numpy-made
rays; and the builder's two switches, `pipelined` and `mxu_chunk`, with
their environment defaults and errors.

On the CPU the K5 wrapper runs its plain twin, the proposal twin followed
by the field/composite twin."""

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
from nerf_emitter_tpu_torch.ops import mega_query as tmq

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


@pytest.mark.parametrize("n", [100, 300], ids=["one_tile", "three_tiles"])
def test_pipelined_query_matches_jax_pipelined(n, clean_env):
    """The port's K5 query against the JAX pipelined megakernel at one and
    three padded 128-ray tiles, at the JAX suite's mega bar (rtol 3e-2, atol
    1e-3): the TPU kernel's inverse CDF is a telescoped ramp sum, the port's
    a CDF walk, and the two differ by ~1e-4 of the spacing range."""
    jm, params, jr, pm, tr = _pair(n)
    ref = j_mega_query(jm, pipelined=True)(params, jr, camera_index=jnp.int32(1))
    query = tmq.make_mega_radiance_query(pm, pipelined=True, device="cpu")
    out = query(pm, tr, camera_index=1)
    assert out.shape == (n, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=3e-2, atol=1e-3)


def test_pipelined_equals_two_kernel_on_the_cpu(clean_env):
    """On the CPU both configurations run the same twins: the answers are
    equal, and gradients through the pipelined query (the staged recompute)
    are finite and equal to the two-kernel query's."""
    _, _, _, pm, tr = _pair(150)
    pipe = tmq.make_mega_radiance_query(pm, pipelined=True, device="cpu")
    two = tmq.make_mega_radiance_query(pm, pipelined=False, device="cpu")
    with torch.no_grad():
        torch.testing.assert_close(pipe(pm, tr, camera_index=1), two(pm, tr, camera_index=1),
                                   rtol=0.0, atol=0.0)
    grads = []
    for q in (pipe, two):
        o = tr.origins.clone().requires_grad_()
        grads.append(torch.autograd.grad(q(pm, tr.replace(origins=o), camera_index=1).sum(), o)[0])
    assert torch.isfinite(grads[0]).all() and grads[0].abs().sum() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0.0, atol=0.0)


def _spy(monkeypatch):
    """Record which kernel wrappers a query's forward calls, and with which
    mxu_chunk."""
    calls = []
    for name in ("mega_pipeline", "proposal_bins", "field_composite"):
        real = getattr(tmq, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("mxu_chunk")))
            return _real(*a, **kw)

        monkeypatch.setattr(tmq, name, spy)
    return calls


@pytest.mark.parametrize("env,kwargs,pipelined,chunk", [
    ({}, {}, True, 1),
    ({"NERF_EMITTER_MEGA_PIPELINED": "0"}, {}, False, 1),
    ({"NERF_EMITTER_MEGA_PIPELINED": "1", "NERF_EMITTER_MEGA_MXU_CHUNK": "3"}, {}, True, 3),
    ({"NERF_EMITTER_MEGA_PIPELINED": "0"}, {"pipelined": True, "mxu_chunk": 2}, True, 2),
    ({}, {"pipelined": False}, False, 1),
], ids=["default_on", "env_off", "env_chunk", "args_over_env", "arg_off"])
def test_builder_switches(env, kwargs, pipelined, chunk, clean_env):
    """pipelined=None reads NERF_EMITTER_MEGA_PIPELINED (default "1") and
    mxu_chunk=None NERF_EMITTER_MEGA_MXU_CHUNK (default "1"), as the JAX
    builder does; the forward runs K5 with that chunk, or K3 then K4; the
    chunk does not change the answer."""
    _, _, _, pm, tr = _pair(40)
    for k, v in env.items():
        clean_env.setenv(k, v)
    query = tmq.make_mega_radiance_query(pm, device="cpu", **kwargs)
    assert (query.pipelined, query.mxu_chunk) == (pipelined, chunk)
    calls = _spy(clean_env)
    with torch.no_grad():
        out = query(pm, tr, camera_index=1)
    if pipelined:
        assert calls == [("mega_pipeline", chunk)]
    else:
        assert [c[0] for c in calls] == ["proposal_bins", "field_composite"]
    with torch.no_grad():
        ref = tmq.make_mega_radiance_query(pm, pipelined=True, mxu_chunk=1, device="cpu")(pm, tr, 1)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=0.0)


@pytest.mark.parametrize("env,kwargs", [
    ({"NERF_EMITTER_MEGA_MXU_CHUNK": "two"}, {}),
    ({"NERF_EMITTER_MEGA_MXU_CHUNK": "1.5"}, {}),
    ({"NERF_EMITTER_MEGA_MXU_CHUNK": "0"}, {}),
    ({}, {"mxu_chunk": 0}),
], ids=["env_word", "env_float", "env_zero", "arg_zero"])
def test_builder_switch_errors_match_jax(env, kwargs, clean_env):
    """A chunk that is not an integer, or below 1, raises the JAX builder's
    ValueError, word for word."""
    jm, _, _, pm, _ = _pair(8)
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError) as ref:
        j_mega_query(jm, **kwargs)
    with pytest.raises(ValueError) as got:
        tmq.make_mega_radiance_query(pm, device="cpu", **kwargs)
    assert str(got.value) == str(ref.value)


def test_builder_reads_the_environment_once(clean_env):
    """The switches are read when the query is built: changing the
    environment afterwards changes neither the query's configuration nor
    the path its forward takes."""
    _, _, _, pm, tr = _pair(40)
    clean_env.setenv("NERF_EMITTER_MEGA_PIPELINED", "0")
    clean_env.setenv("NERF_EMITTER_MEGA_MXU_CHUNK", "2")
    two = tmq.make_mega_radiance_query(pm, device="cpu")
    clean_env.setenv("NERF_EMITTER_MEGA_PIPELINED", "1")
    clean_env.setenv("NERF_EMITTER_MEGA_MXU_CHUNK", "not-a-number")
    calls = _spy(clean_env)
    with torch.no_grad():
        two(pm, tr, camera_index=1)
    assert (two.pipelined, two.mxu_chunk) == (False, 2)
    assert [c[0] for c in calls] == ["proposal_bins", "field_composite"]


def test_mega_pipeline_twin_is_k3_then_k4():
    """The K5 twin with its aux output equals the K4 twin on the K3 twin's
    bins: the TPU kernel's per-tile math is that of the two-kernel path."""
    _, _, _, pm, tr = _pair(128)
    from nerf_emitter_tpu_torch.ops import fused_field as tff

    p = tff.named_params(pm)
    rows = [t.T.contiguous() for t in (tr.origins, tr.directions, tr.nears, tr.fars)]
    (ws0, bs0), (ws1, bs1) = tff._mlp_params(p, "proposal_0.mlp"), tff._mlp_params(p, "proposal_1.mlp")
    bws, bbs = tff._mlp_params(p, "field.base_mlp")
    hws, hbs = tff._mlp_params(p, "field.head_mlp")
    props = (tff.permute_first(ws0, 4), bs0, tff.permute_first(ws1, 6), bs1)
    field = (tff.permute_first(bws, 10), bbs, hws, hbs)
    emb = p["field.appearance_embedding.weight"][1]
    box = dict(aabb_lo=(-1.5,) * 3, aabb_inv_ext=(1 / 3,) * 3, disable_box=None, avg_density=1.0)
    with torch.no_grad():
        rgb, aux = tmq.mega_pipeline(*rows, emb, *props, *field, s0=12, s1=8, s2=6, freqs0=4, freqs1=6,
                                     freqs=10, hdr=True, rgb_bias=0.0, mxu_chunk=3, with_aux=True, **box)
        sbins = tmq.proposal_bins(*rows, *props, s0=12, s1=8, s2=6, freqs0=4, freqs1=6, **box)
        rgb2, aux2 = tmq.field_composite(sbins, *rows, emb, *field, s2=6, freqs=10, hdr=True,
                                         rgb_bias=0.0, with_aux=True, **box)
    torch.testing.assert_close(rgb, rgb2, rtol=0.0, atol=0.0)
    torch.testing.assert_close(aux, aux2, rtol=0.0, atol=0.0)
    with pytest.raises(ValueError, match="mxu_chunk"):
        tmq.mega_pipeline(*rows, emb, *props, *field, s0=12, s1=8, s2=6, freqs0=4, freqs1=6, freqs=10,
                          hdr=True, rgb_bias=0.0, mxu_chunk=0, **box)
