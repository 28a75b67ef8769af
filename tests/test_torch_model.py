"""The port's fields and NerfactoModel (freq) against JAX model.apply on
one set of weights, carried across by the bridge, and the bridge's own
checks.

Both sides run flax Dense(dtype=bf16) arithmetic with direct sin/cos
encodings, but bf16 roundings can land differently (XLA and torch sum
in other orders), so the bar is the JAX suite's: rtol 2e-2, atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.rays import RayBundle as JRayBundle
from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu_torch.bridge import load_flax_params
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel

torch.set_num_threads(1)

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
BOX = ((-0.4, -0.4, -0.4), (0.4, 0.4, 0.4))
CFG = dict(num_nerf_samples=6, num_proposal_samples=(12, 8), num_cameras=4,
           appearance_embedding_dim=8, implementation="freq")
RTOL, ATOL = 2e-2, 1e-4


def _rays(n=16, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = dict(
        origins=rng.uniform(-0.3, 0.3, size=(n, 3)).astype(np.float32), directions=d,
        pixel_area=np.full((n, 1), 1e-4, np.float32),
        nears=np.full((n, 1), 0.05, np.float32), fars=np.full((n, 1), 3.0, np.float32),
        camera_indices=rng.integers(0, 4, size=(n, 1)).astype(np.int32),
    )
    jr = JRayBundle(**{k: jnp.asarray(v) for k, v in r.items()})
    tr = RayBundle(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
                      for k, v in r.items()})
    return jr, tr


def _pair():
    jm = JModel(aabb=AABB, **CFG)
    jr, _ = _rays()
    params = jm.init(jax.random.PRNGKey(3), jr)
    pm = NerfactoModel(AABB, device="cpu", **CFG)
    load_flax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_bridge_loads_every_parameter():
    jm, params, pm = _pair()
    f = params["params"]["field"]
    np.testing.assert_array_equal(pm.field.base_mlp.hidden_0.weight.detach().numpy(),
                                  np.asarray(f["base_mlp"]["hidden_0"]["kernel"]).T)
    np.testing.assert_array_equal(pm.field.appearance_embedding.weight.detach().numpy(),
                                  np.asarray(f["appearance_embedding"]["embedding"]))
    np.testing.assert_array_equal(pm.proposal_1.mlp.out.bias.detach().numpy(),
                                  np.asarray(params["params"]["proposal_1"]["mlp"]["out"]["bias"]))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_refuses_a_tree_that_does_not_fit(fault):
    _, params, pm = _pair()
    tree = jax.tree.map(np.asarray, params)["params"]
    mlp = tree["field"]["base_mlp"]
    if fault == "missing":
        del mlp["hidden_4"]
    elif fault == "extra":
        mlp["hidden_5"] = mlp["hidden_4"]
    else:
        mlp["out"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        load_flax_params(pm, tree)


@pytest.mark.parametrize("box", [None, BOX], ids=["nobox", "carveout"])
def test_fields_match_jax(box):
    jm, params, pm = _pair()
    pos = np.random.default_rng(1).uniform(-1.7, 1.7, size=(64, 3)).astype(np.float32)
    dirs = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = np.arange(64, dtype=np.int32)[:, None] % 4
    jbox = None if box is None else jnp.asarray(box)
    kw = dict(disable_aabb_on=box is not None)
    jd, jg = jm.apply(params, jnp.asarray(pos), method=lambda m, x: m.field.get_density(
        x, disable_aabb=jbox, **kw))
    td, tg = pm.field.get_density(torch.from_numpy(pos), disable_aabb=box, **kw)
    _close(td, jd)
    _close(tg, jg)
    jrgb = jm.apply(params, jg, jnp.asarray(dirs), jnp.asarray(cams),
                    method=lambda m, g, d, c: m.field.get_rgb(g, d, c))
    trgb = pm.field.get_rgb(tg, torch.from_numpy(dirs), torch.from_numpy(cams.astype(np.int64)))
    _close(trgb, jrgb)
    for lvl in (0, 1):
        jp = jm.apply(params, jnp.asarray(pos), method=lambda m, x: m.proposal_networks[lvl](
            x, disable_aabb=jbox, **kw))
        _close(pm.proposal_networks[lvl](torch.from_numpy(pos), disable_aabb=box, **kw), jp)


@pytest.mark.parametrize("box", [None, BOX], ids=["nobox", "carveout"])
def test_model_eval_outputs_match_jax(box):
    jm, params, pm = _pair()
    jr, tr = _rays()
    jbox = None if box is None else jnp.asarray(box)
    ref = jm.apply(params, jr, train=False, disable_aabb=jbox, disable_aabb_on=box is not None)
    out = pm(tr, disable_aabb=box, disable_aabb_on=box is not None)
    for k in ("rgb", "accumulation", "depth"):
        assert out[k].shape == ref[k].shape, k
        _close(out[k], ref[k])
    rgb_only = pm(tr, disable_aabb=box, disable_aabb_on=box is not None, hdr_radiance_only=True)
    assert list(rgb_only) == ["rgb", "spacing_bins"]
    np.testing.assert_array_equal(rgb_only["rgb"].detach().numpy(), out["rgb"].detach().numpy())
    # the final samples' edges given back replace the proposal stage: the same answer
    again = pm(tr, disable_aabb=box, disable_aabb_on=box is not None, hdr_radiance_only=True,
               spacing_bins=rgb_only["spacing_bins"])
    np.testing.assert_array_equal(again["rgb"].detach().numpy(), out["rgb"].detach().numpy())
