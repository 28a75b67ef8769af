"""The port's NeRF pretraining against the JAX package: the schedules, the
group labels, per-group Adam against optax, the training forward, one
step's loss and gradients, three optimiser steps, the eval renderer, a
tiny CPU run, and the stochastic paths.

The models are tests/test_torch_hash.py's tiny NeRF (`hash_pair`: the hash
grid, f32-exact against JAX) and the same size with the `freq` field (a
bf16 6x256 MLP, held at the JAX suite's model bar). Parity runs are
deterministic on both sides: the reference's key=None and the port's
generator=None, on numpy-made rays and targets."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_emitter_tpu.cameras.cameras import Cameras as JCameras
from nerf_emitter_tpu.engine import optimizers as JO
from nerf_emitter_tpu.engine import schedulers as JS
from nerf_emitter_tpu.engine import train_loop as JT
from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.ops import losses as JL
from nerf_emitter_tpu_torch.bridge import _flax_path, load_flax_params
from nerf_emitter_tpu_torch.cameras.cameras import Cameras
from nerf_emitter_tpu_torch.data.datamanager import ImageDataset
from nerf_emitter_tpu_torch.engine import optimizers as TO
from nerf_emitter_tpu_torch.engine import schedulers as TS
from nerf_emitter_tpu_torch.engine import train_loop as TT
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.parallel.mesh import make_mesh
from test_torch_hash import AABB, TINY, _both, _rays_np, hash_pair

torch.set_num_threads(1)

FREQ = dict(TINY, implementation="freq")
# the bars of the two fields against JAX: hash f32-exact (tests/test_torch_hash.py),
# freq the JAX suite's for bf16 models (tests/test_torch_model.py)
BARS = {"hash": (1e-5, 1e-6), "freq": (2e-2, 1e-4)}
ANNEAL = 0.3


def freq_pair(seed=0):
    jm = JModel(aabb=AABB, **FREQ)
    jr, _ = _both(_rays_np(4))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jr)
    pm = NerfactoModel(AABB, device="cpu", **FREQ)
    load_flax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm


@pytest.fixture(scope="module")
def refs():
    """Per field: the JAX model, its parameters, the port's model with the
    same weights (tests copy it before training it) and the jitted
    value_and_grad of the reference step's loss (_j_loss), each built
    once for the module."""
    out = {}
    for impl, make in (("hash", hash_pair), ("freq", freq_pair)):
        jm, params, pm = make()
        out[impl] = (jm, params, pm, jax.jit(jax.value_and_grad(_j_loss(jm, TT.TrainConfig()))))
    return out


def _pair(refs, impl):
    jm, params, pm, vg = refs[impl]
    return jm, params, copy.deepcopy(pm), vg


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _by_torch_name(pm, jax_tree):
    """A flax-shaped tree (gradients, labels) keyed by the port's parameter
    names, in the port's layout."""
    flat = _flat(jax.tree.map(np.asarray, jax_tree)["params"])
    out = {}
    for name, _ in pm.named_parameters():
        path, transpose = _flax_path(pm, name)
        out[name] = flat[path].T if transpose else flat[path]
    return out


def _batch(n=64, seed=5):
    jr, tr = _both(_rays_np(n, seed=seed))
    gt = np.abs(np.random.default_rng(seed + 1).normal(0.5, 0.5, size=(n, 3))).astype(np.float32)
    return jr, tr, gt


def _j_loss(jm, config):
    """The reference step's loss composed from the JAX package's own
    functions (engine/train_loop.py's loss_fn with key=None):
    loss(params, rays, gt, anneal)."""
    fns = [JL.RGB_LOSSES[config.rgb_loss]] + (
        [JL.RGB_LOSSES[config.rgb_loss_second]] if config.rgb_loss_second else [])

    def loss(params, jr, gt, anneal):
        out = jm.apply(params, jr, key=None, train=True, proposal_anneal=anneal)
        rgb = sum(f(out["rgb"], gt) for f in fns) / len(fns)
        il = JL.interlevel_loss(out["weights_list"], out["spacing_bins_list"])
        rs = out["ray_samples"]
        dl = JL.distortion_loss(out["weights_list"][-1], rs.spacing_starts, rs.spacing_ends)
        return rgb + config.interlevel_mult * il + config.distortion_mult * dl

    return loss


def test_train_config_matches_jax():
    """The same fields with the same defaults."""
    ref = {f.name: f.default for f in dataclasses.fields(JT.TrainConfig)}
    assert {f.name: f.default for f in dataclasses.fields(TT.TrainConfig)} == ref
    # without a process group the mesh is one rank: the state is the one-rank state
    state, _ = TT.create_train_state(NerfactoModel(AABB, device="cpu", **TINY), TT.TrainConfig(data_axis="data"),
                                     make_mesh(device_type="cpu"))
    assert state.step == 0


@pytest.mark.parametrize("kw", [
    dict(lr_init=1e-3, lr_final=1e-4, max_steps=2320, step_pretrain=2000, lr_lambda=0.01),
    dict(lr_init=1e-2, lr_final=1e-3, max_steps=1000, warmup_steps=100),
    dict(lr_init=1e-3, max_steps=2320),
], ids=["sdf_nerfacto", "warmup", "constant"])
def test_lr_schedules_match_jax(kw):
    """Steps 0-2,400, through the warm-up, the decay, the x0.01 drop at
    step_pretrain and past max_steps; JAX computes in f32 (rtol 2e-6)."""
    steps = np.arange(2401)
    ref = np.asarray(JS.exponential_decay_schedule(**kw)(jnp.asarray(steps)))
    port = np.array([TS.exponential_decay_schedule(**kw)(int(k)) for k in steps])
    np.testing.assert_allclose(port, ref, rtol=2e-6)
    if "step_pretrain" in kw:
        assert port[2000] == pytest.approx(port[1999] * 0.01, rel=1e-3)


@pytest.mark.parametrize("anneal_steps,slope", [(1000, 10.0), (20, 3.0)])
def test_anneal_schedule_matches_jax(anneal_steps, slope):
    steps = np.arange(2401)
    ref = np.asarray(JS.proposal_anneal_schedule(anneal_steps, slope)(jnp.asarray(steps)))
    port = np.array([TS.proposal_anneal_schedule(anneal_steps, slope)(int(k)) for k in steps])
    np.testing.assert_allclose(port, ref, rtol=2e-6, atol=1e-7)


def _flax_tree(pm):
    """The port's parameters as the flax tree the bridge maps them from."""
    tree = {}
    for name, p in pm.named_parameters():
        path, transpose = _flax_path(pm, name)
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = p.detach().numpy().T if transpose else p.detach().numpy()
    return {"params": tree}


def test_group_labels_match_jax(refs):
    """label_params_by_prefix on the port's names against the reference's
    labels of the same parameters in their flax tree (the bridge's paths;
    for the tiny hash NeRF the very tree JAX's init made), with both
    pose-delta tables."""
    _, params, pm, _ = refs["hash"]
    assert set(_flat(_flax_tree(pm))) == set(_flat(jax.tree.map(np.asarray, params)))
    pm = NerfactoModel(AABB, device="cpu", optimize_camera_poses=True, optimize_rotations=True, num_rotations=3,
                       **TINY)
    ref = _by_torch_name(pm, JO.label_params_by_prefix(_flax_tree(pm)))
    labels = {name: TO.label_params_by_prefix(name) for name, _ in pm.named_parameters()}
    assert labels == {k: str(v) for k, v in ref.items()}
    assert set(labels.values()) == {"fields", "proposal_networks", "camera_opt"}


_CLIPS = {"plain": (None, None, 0.0), "max_value": (0.5, None, 0.0), "max_norm": (None, 1.0, 0.0),
          "weight_decay": (None, None, 0.05), "all": (0.5, 1.0, 0.05)}


@pytest.mark.parametrize("clip", sorted(_CLIPS))
def test_adam_groups_match_optax(clip):
    """5 steps of per-group Adam on fixed gradients against optax's
    multi_transform of the reference's chains: fields with the x0.01 drop
    at step 3 and the clips of this case, proposals with a warm-up,
    camera_opt plain. f32 on both sides: rtol 1e-5, atol 1e-7."""
    max_value, max_norm, wd = _CLIPS[clip]
    groups = {
        "fields": dict(lr=1e-2, lr_final=1e-3, max_steps=5, step_pretrain=3, lr_lambda=0.01,
                       max_value=max_value, max_norm=max_norm, weight_decay=wd),
        "proposal_networks": dict(lr=5e-3, max_steps=5, warmup_steps=2),
        "camera_opt": dict(lr=1e-3, max_steps=5),
    }
    rng = np.random.default_rng(7)
    init = {"field.w": (6, 4), "field.b": (4,), "proposal_0.w": (3, 5), "camera_opt_deltas": (4, 6)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in init.items()}
    grads = [{k: (2.0 * rng.normal(size=v.shape)).astype(np.float32) for k, v in init.items()} for _ in range(5)]

    def tree(flat):
        return {"params": {"field": {"w": flat["field.w"], "b": flat["field.b"]},
                           "proposal_0": {"w": flat["proposal_0.w"]},
                           "camera_opt_deltas": flat["camera_opt_deltas"]}}

    tx = JO.build_optimizer({k: JO.OptimizerGroupConfig(**v) for k, v in groups.items()},
                            JO.label_params_by_prefix)
    jp = jax.tree.map(jnp.asarray, tree(init))
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = TO.build_optimizer({k: TO.OptimizerGroupConfig(**v) for k, v in groups.items()}, tp.items())
    assert set(opt.groups) == set(groups)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, tree(g)), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        ref = _flat(jax.tree.map(np.asarray, jp)["params"])
        for k, path in (("field.w", "field/w"), ("field.b", "field/b"), ("proposal_0.w", "proposal_0/w"),
                        ("camera_opt_deltas", "camera_opt_deltas")):
            np.testing.assert_allclose(tp[k].detach().numpy(), ref[path], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("impl", ["hash", "freq"])
def test_train_outputs_match_jax(refs, impl):
    """forward(train=True, proposal_anneal=0.3) against model.apply(train=
    True, key=None): rgb, accumulation, depth, the three levels' weights and
    spacing bins, and the field's samples; at the field's bar (BARS)."""
    jm, params, pm, _ = _pair(refs, impl)
    jr, tr, _ = _batch()
    rtol, atol = BARS[impl]
    ref = jax.jit(lambda p, r: jm.apply(p, r, key=None, train=True, proposal_anneal=ANNEAL))(params, jr)
    out = pm(tr, train=True, proposal_anneal=ANNEAL)
    assert len(out["weights_list"]) == len(out["spacing_bins_list"]) == 3
    pairs = [(out[k], ref[k]) for k in ("rgb", "accumulation", "depth")]
    pairs += list(zip(out["weights_list"], ref["weights_list"]))
    pairs += list(zip(out["spacing_bins_list"], ref["spacing_bins_list"]))
    rs, jrs = out["ray_samples"], ref["ray_samples"]
    pairs += [(rs.spacing_starts, jrs.spacing_starts), (rs.frustums.ends, jrs.frustums.ends)]
    for a, b in pairs:
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=atol)
    assert [w.shape[1] for w in out["weights_list"]] == [12, 8, 8]


# one step's loss and gradients. hash: the loss f32-exact (measured 6e-8
# relative), each parameter's gradient within 1% of its largest component
# (measured 7e-3: JAX sums the bf16 MLP bias cotangents in bf16). freq: the
# bf16 6x256 MLPs round otherwise along the chain; the loss at 1e-4
# relative (measured 1.5e-5) and each gradient by its relative L2 error
# (bar 0.1) and cosine (bar 0.995).
@pytest.mark.parametrize("impl", ["hash", "freq"])
def test_one_step_loss_and_gradients_match_jax(refs, impl):
    jm, params, pm, vg = _pair(refs, impl)
    jr, tr, gt = _batch()
    config = TT.TrainConfig()
    ref_loss, ref_g = vg(params, jr, gt, ANNEAL)
    total, metrics = TT.nerfacto_loss(pm, config, tr, torch.from_numpy(gt), torch.ones(64, 1),
                                      proposal_anneal=ANNEAL)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(ref_loss), rtol=1e-6 if impl == "hash" else 1e-4)
    assert set(metrics) == {"loss", "rgb_loss", "interlevel", "distortion", "psnr_linear"}
    want = _by_torch_name(pm, ref_g)
    nonzero = 0
    for name, p in pm.named_parameters():
        got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
        top = float(np.abs(want[name]).max())
        nonzero += top > 0
        if impl == "hash":
            assert np.abs(got - want[name]).max() <= 1e-2 * top, name
        elif top > 0:
            rel = np.linalg.norm(got - want[name]) / np.linalg.norm(want[name])
            cos = float((got * want[name]).sum() / (np.linalg.norm(got) * np.linalg.norm(want[name])))
            assert rel <= 0.1 and cos >= 0.995, (name, rel, cos)
    assert nonzero >= len(want) // 2


def test_three_optimizer_steps_match_optax(refs):
    """Three steps of the sdf-nerfacto chains (lr 1e-2 here, so the steps
    move the loss) on one fed batch: the port's nerfacto_loss, backward and
    MultiOptimizer against value_and_grad and build_nerfacto_optimizer's
    optax chain. With eps 1e-15 Adam's first update is +-lr on any
    non-zero gradient, roundoff too, so the parameters are held only where
    both gradients agree within 1% at every step (at least half of them),
    the rest through the loss before each step (rtol 5e-4; measured 8e-5
    at the third)."""
    jm, params, pm, vg = _pair(refs, "hash")
    jr, tr, gt = _batch()
    config = TT.TrainConfig(max_steps=3)
    tx = JT.build_nerfacto_optimizer(JT.TrainConfig(max_steps=3), params)
    opt_state = tx.init(params)
    state, opt = TT.create_train_state(pm, config)
    assert state.step == 0 and set(opt.groups) == {"fields", "proposal_networks"}
    held = {name: np.ones(p.shape, bool) for name, p in pm.named_parameters()}
    moved = {name: np.zeros(p.shape, bool) for name, p in pm.named_parameters()}
    for _ in range(3):
        ref_loss, ref_g = vg(params, jr, gt, ANNEAL)
        updates, opt_state = tx.update(ref_g, opt_state, params)
        params = optax.apply_updates(params, updates)
        total, _ = TT.nerfacto_loss(pm, config, tr, torch.from_numpy(gt), torch.ones(64, 1), proposal_anneal=ANNEAL)
        opt.zero_grad()
        total.backward()
        np.testing.assert_allclose(float(total.detach()), float(ref_loss), rtol=5e-4)
        want = _by_torch_name(pm, ref_g)
        for name, p in pm.named_parameters():
            got = np.zeros_like(want[name]) if p.grad is None else p.grad.numpy()
            held[name] &= np.abs(got - want[name]) <= 1e-2 * np.abs(want[name])
            moved[name] |= want[name] != 0
        opt.step()
        state.step += 1
    ref = _by_torch_name(pm, params)
    n_moved = sum(int(m.sum()) for m in moved.values())
    assert sum(int((h & moved[k]).sum()) for k, h in held.items()) >= n_moved // 2 > 0
    for name, p in pm.named_parameters():
        got = p.detach().numpy()[held[name]]
        np.testing.assert_allclose(got, ref[name][held[name]], rtol=0.0, atol=0.02 * config.lr_fields, err_msg=name)
    assert opt.lrs()["fields"] == pytest.approx(float(JS.exponential_decay_schedule(1e-2, 1e-3, 3)(3)), rel=1e-6)


def _ring_cameras(n=3, res=16):
    """n perspective cameras on a ring at radius 0.8, looking at the origin."""
    c2w = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([0.8 * np.sin(a), 0.2, 0.8 * np.cos(a)])
        f = -eye / np.linalg.norm(eye)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r /= np.linalg.norm(r)
        c2w.append(np.stack([r, np.cross(r, f), -f, eye], -1))
    c2w = np.asarray(c2w, np.float32)
    focal = np.full(n, res * 0.8, np.float32)
    half = np.full(n, res / 2, np.float32)
    j = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(focal), fy=jnp.asarray(focal),
                 cx=jnp.asarray(half), cy=jnp.asarray(half), width=res, height=res)
    t = Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(focal), fy=torch.from_numpy(focal),
                cx=torch.from_numpy(half), cy=torch.from_numpy(half), width=res, height=res)
    return j, t


def test_render_fn_matches_jax(refs):
    """make_render_fn on a 16x16 image of the hash model (far 3) against
    JAX's lax.map renderer; chunk 100 leaves a part-filled last chunk (JAX
    pads it). rtol 1e-4, atol 1e-5: the two packages' camera rays differ in
    the last ulp (measured 3.4e-5 on 3 of 768 values near 1.1)."""
    jm, params, pm, _ = _pair(refs, "hash")
    jc, tc = _ring_cameras()
    config = TT.TrainConfig(far=3.0)
    ref = JT.make_render_fn(jm, JT.TrainConfig(far=3.0), chunk=100)(params, jc, jnp.int32(1), 16, 16)
    out = TT.make_render_fn(pm, config, chunk=100)(tc, 1, 16, 16)
    for k in ("rgb", "depth", "accumulation"):
        assert out[k].shape == ref[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def _tiny_dataset(n=6, res=16, seed=0):
    """Ring views of an analytic scene: brighter toward +y, a dark band."""
    _, cams = _ring_cameras(n, res)
    rng = np.random.default_rng(seed)
    img = 0.4 + 0.3 * np.linspace(0, 1, res)[None, :, None, None] * np.ones((n, res, res, 3))
    img[:, res // 3: res // 2] *= 0.2
    img = (img * rng.uniform(0.9, 1.1, size=(n, 1, 1, 3))).astype(np.float32)
    return ImageDataset(cameras=cams, images=torch.from_numpy(img))


def test_tiny_cpu_run_lowers_the_loss(refs):
    """40 steps of make_train_step on the tiny hash NeRF (lr 1e-2, 256 rays,
    far 3) lower the rgb loss: the last 5 steps' mean below 0.7x the first
    5's (tests/test_train_slice.py's bar); every metric finite, the step
    counted, the rendered view finite."""
    _, _, pm, _ = _pair(refs, "hash")
    ds = _tiny_dataset()
    config = TT.TrainConfig(num_rays_per_batch=256, far=3.0, max_steps=50, anneal_steps=20)
    state, opt = TT.create_train_state(pm, config)
    step = TT.make_train_step(pm, config, opt)
    g = torch.Generator().manual_seed(42)
    hist = [step(state, ds, g) for _ in range(40)]
    rgb = np.array([float(m["rgb_loss"]) for m in hist])
    assert state.step == 40
    assert all(np.isfinite(float(v)) for m in hist for v in m.values())
    assert rgb[-5:].mean() < 0.7 * rgb[:5].mean(), rgb
    img = TT.make_render_fn(pm, config, chunk=128)(ds.cameras, 0, 16, 16)["rgb"]
    assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())


def test_stochastic_paths_shapes_and_ranges(refs):
    """The generator's paths: stratified bins sorted in [0, 1] at every
    level, weights in [0, 1] summing to at most 1, the same draws for the
    same seed and others for another; the random background draws where
    the background colour is 'random', and none without a generator."""
    _, _, pm, _ = _pair(refs, "hash")
    _, tr, _ = _batch(32)

    def run(seed, model=pm):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return model(tr, generator=g, train=True, proposal_anneal=ANNEAL)

    a, b, c = run(0), run(0), run(1)
    for bins, w in zip(a["spacing_bins_list"], a["weights_list"]):
        assert bins.shape == (32, w.shape[1] + 1)
        assert float(bins.min()) >= 0.0 and float(bins.max()) <= 1.0
        assert bool((bins[:, 1:] >= bins[:, :-1]).all())
        assert float(w.min()) >= 0.0 and float(w.sum(-1).max()) <= 1.0 + 1e-6
    assert torch.equal(a["rgb"], b["rgb"]) and not torch.equal(a["rgb"], c["rgb"])
    assert not torch.equal(a["spacing_bins_list"][0], c["spacing_bins_list"][0])
    det = run(None)
    np.testing.assert_allclose(det["spacing_bins_list"][0][:, 1:-1].numpy(),
                               np.broadcast_to((np.arange(1, 12) / 12.0).astype(np.float32), (32, 11)), atol=1e-7)
    try:
        pm.background_color = "black"
        black = run(None)
        pm.background_color = "random"
        r0, r1, r2, rd = run(0), run(0), run(1), run(None)
    finally:
        pm.background_color = "last_sample"
    assert torch.equal(r0["rgb"], r1["rgb"]) and not torch.equal(r0["rgb"], r2["rgb"])
    assert torch.equal(rd["rgb"], black["rgb"])  # no generator: a black background
