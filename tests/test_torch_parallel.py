"""Training across ranks (nerf_emitter_tpu_torch/parallel/mesh.py) on the
CPU: two gloo ranks, spawned once for the module, against the one-rank
result on the same inputs, and against JAX where a JAX function exists at
the same weights (bridge.load_flax_params). The ranks' scenarios:

- rows: data_sharded / gather_rows with padding and their gradients,
  shard_leading_axis, replicated and max_replica_difference;
- the NeRF train step (64 rays; tests/test_multichip.py's bars after one
  step: loss rtol 1e-5, parameters rtol 2e-4, atol 1e-6; then a second
  step's loss);
- the eval renderer (chunks split over the ranks), against JAX's;
- shard_fused_query on the kernel query's plain twin, against JAX's
  _shard_fused_query on the 8-device CPU mesh (n = 64, not a multiple of
  128; rtol 2e-3, atol 2e-4), its parameter gradient against one rank's;
- the takeover step at tests/test_capture_hygiene.py's sizes (2 images of
  4^2, a 9^3 grid), exact and aggregate (2 gradient bands, curvature on);
- the pipeline's two phases (NeRF steps, the TSDF init, the guiding, the
  distilled cache, takeover steps), its sharded render_camera_outputs,
  and its replicas.
And in this process: the kernel query's backward in fixed-size chunks.

The ranks import neither JAX nor the JAX package (their scenarios live at
this module's top, its JAX imports inside the tests).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nerf_emitter_tpu_torch.cameras.cameras import Cameras
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.data.datamanager import ImageDataset
from nerf_emitter_tpu_torch.engine import train_loop as TT
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops.fused_field import named_params
from nerf_emitter_tpu_torch.ops.mega_query import make_mega_radiance_query
from nerf_emitter_tpu_torch.parallel import mesh as pm
from nerf_emitter_tpu_torch.pipelines import nerf_emitter as tne
from nerf_emitter_tpu_torch.pipelines import sdf_optimizer as tso
from nerf_emitter_tpu_torch.renderer import optimize as topt
from nerf_emitter_tpu_torch.renderer.integrator import RenderConfig
from nerf_emitter_tpu_torch.renderer.scene import SdfScene
from nerf_emitter_tpu_torch.renderer.sphere_trace import SphereTraceConfig
from nerf_emitter_tpu_torch.scripts.train import free_port

torch.set_num_threads(1)

WORLD = 2
AABB = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
TINY = dict(num_nerf_samples=8, num_proposal_samples=(12, 8), log2_hashmap_size=12, max_res=128, num_cameras=6,
            appearance_embedding_dim=4)
FREQ = dict(TINY, implementation="freq")
QUERY_RAYS = 64  # not a multiple of 128, nor of the JAX mesh's 8 devices times 128


# ---- what each rank runs (and the parent, as the one-rank reference)


def ring_cameras(n: int, res: int, radius: float = 0.8, focal: float | None = None) -> tuple[np.ndarray, float]:
    """(c2w (n, 3, 4), focal) of n cameras on a ring looking at the origin."""
    c2w = []
    for i in range(n):
        a = 2 * np.pi * i / n + 0.2
        eye = np.array([radius * np.sin(a), 0.25, radius * np.cos(a)])
        f = -eye / np.linalg.norm(eye)
        r = np.cross(f, [0.0, 1.0, 0.0])
        r /= np.linalg.norm(r)
        c2w.append(np.stack([r, np.cross(r, f), -f, eye], -1))
    return np.asarray(c2w, np.float32), res * 0.8 if focal is None else focal


def cameras(c2w: np.ndarray, focal: float, res: int) -> Cameras:
    n = c2w.shape[0]
    return Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.full((n,), focal), fy=torch.full((n,), focal),
                   cx=torch.full((n,), res / 2), cy=torch.full((n,), res / 2), width=res, height=res)


def dataset(n: int = 6, res: int = 8, seed: int = 0) -> ImageDataset:
    c2w, f = ring_cameras(n, res)
    img = np.random.default_rng(seed).uniform(0.1, 0.9, size=(n, res, res, 3)).astype(np.float32)
    return ImageDataset(cameras=cameras(c2w, f, res), images=torch.from_numpy(img))


def model_of(state: dict, **cfg) -> NerfactoModel:
    m = NerfactoModel(AABB, device="cpu", **cfg)
    m.load_state_dict(state)
    return m


def query_rays(n: int = QUERY_RAYS) -> RayBundle:
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return RayBundle(origins=torch.zeros((n, 3)), directions=torch.from_numpy(d), pixel_area=torch.full((n, 1), 1e-4),
                     nears=torch.full((n, 1), 0.05), fars=torch.full((n, 1), 4.0),
                     camera_indices=torch.zeros((n, 1), dtype=torch.long))


def s_rows(mesh, inp) -> dict:
    x = torch.arange(21, dtype=torch.float32).reshape(7, 3).requires_grad_()
    w = torch.linspace(-1.0, 1.0, 21).reshape(7, 3)
    local = pm.data_sharded(x, mesh)
    gathered = pm.gather_rows(local * 2.0, mesh, 7)
    (gathered * w).sum().backward()
    rank = 0 if mesh is None else mesh.rank
    own = torch.full((3,), float(rank))
    before = pm.max_replica_difference(own, mesh)
    pm.replicated(own, mesh)
    leading = pm.shard_leading_axis({"even": torch.arange(8.0), "odd": torch.arange(7.0)}, mesh)
    return dict(local=local.detach(), gathered=gathered.detach(), grad=x.grad, before=before,
                after=pm.max_replica_difference(own, mesh), own=own, even=leading["even"], odd=leading["odd"])


def s_nerf_step(mesh, inp) -> dict:
    model = model_of(inp["hash"], **TINY)
    ds = dataset()
    cfg = TT.TrainConfig(num_rays_per_batch=64, far=3.0, max_steps=10,
                         data_axis=None if mesh is None else pm.DATA_AXIS)
    state, opt = TT.create_train_state(model, cfg, mesh)
    step = TT.make_train_step(model, cfg, opt, mesh=mesh)
    g = torch.Generator().manual_seed(0)
    losses = [float(step(state, ds, g)["loss"])]
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    losses.append(float(step(state, ds, g)["loss"]))
    return dict(losses=losses, params=params)


def s_render(mesh, inp) -> dict:
    model = model_of(inp["hash"], **TINY)
    render = TT.make_render_fn(model, TT.TrainConfig(far=3.0), chunk=24, mesh=mesh,
                               data_axis=None if mesh is None else pm.DATA_AXIS)
    c2w, f = ring_cameras(3, 8)
    return render(cameras(c2w, f, 8), 1, 8, 8)


def s_query(mesh, inp) -> dict:
    model = model_of(inp["freq"], **FREQ)
    query = tne.shard_fused_query(make_mega_radiance_query(model, device="cpu"), mesh)
    params = {k: v.detach().clone().requires_grad_() for k, v in named_params(model).items()}
    out = query(params, query_rays())
    weights = torch.linspace(0.5, 1.5, out.numel()).reshape(out.shape)
    names = sorted(params)
    grads = torch.autograd.grad((out * weights).sum(), [params[k] for k in names], allow_unused=True)
    return dict(out=out.detach(), grads={k: g for k, g in zip(names, grads) if g is not None})


def takeover_parts(inp, spp: int, spp_attached: int, curvature: float):
    """tests/test_capture_hygiene.py's takeover: 2 images of 4^2, a 9^3
    sphere, the tiny NeRF as the emitter."""
    n_imgs, h = 2, 4
    c2w, _ = ring_cameras(n_imgs, h, radius=1.3)
    cams = cameras(c2w, 5.0, h)
    model = model_of(inp["takeover_model"], num_nerf_samples=4, num_proposal_samples=(8,), log2_hashmap_size=10,
                     max_res=32, num_cameras=n_imgs, appearance_embedding_dim=4)
    emitter = tne.make_nerf_emitter_fn(model, 1.0, BOX, detach_nerf=True)(model)
    opt_cfg = topt.SdfOptConfig(
        name="smoke", bsdf_type=0, loss="relative_l1",
        variables=(topt.VariableSpec("sdf", lr=3e-3), topt.VariableSpec("albedo", lr=1e-2, clamp=(0.0, 1.0)),
                   topt.VariableSpec("roughness", lr=0.0, clamp=(0.02, 1.0))),
        init_res=9, tex_res=4, render_upsample_iter=(), curvature_mult=curvature)
    takeover = tso.TakeoverConfig(spp=spp, spp_per_batch=1, spp_attached=spp_attached, image_height=h, image_width=h)
    return cams, emitter, opt_cfg, takeover


def s_takeover(mesh, inp, spp: int = 1, spp_attached: int = 0, curvature: float = 0.0) -> dict:
    cams, emitter, opt_cfg, takeover = takeover_parts(inp, spp, spp_attached, curvature)
    tx = tso.build_sdf_optimizer(opt_cfg)
    scene = SdfScene.create(sdf_res=9, tex_res=4)
    state = tso.SdfOptState(step=0, scene=scene, opt_state=tx.init(scene))
    step = tso.make_sdf_train_step(opt_cfg, takeover, tx, emitter_fn=emitter,
                                   render_config=RenderConfig(trace=SphereTraceConfig(max_steps=4, t_max=3.0)),
                                   mesh=mesh, data_axis=None if mesh is None else pm.DATA_AXIS)
    gt = torch.from_numpy(np.abs(np.random.default_rng(2).normal(size=(2, 4, 4, 3))).astype(np.float32))
    g = torch.Generator().manual_seed(3)
    metrics = []
    for _ in range(2):
        state, m = step(state, cams, torch.tensor([0, 1]), gt, torch.ones((2, 4, 4, 1)), g)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, bands=step.n_grad_bands, sdf=state.scene.sdf, albedo=state.scene.albedo)


def two_phase(mesh, inp):
    """The two phases on the tiny hash NeRF: a view of the NeRF, 3 NeRF
    steps, the takeover (a TSDF fusion, the vMF guiding, a 2-step
    distilled cache) and 2 takeover steps. -> (pipeline, dataset, model,
    the view, the steps' metrics)."""
    ds = dataset(6, 16, seed=1)
    model = model_of(inp["hash"], **TINY)
    cfg = tne.NerfEmitterPipelineConfig(
        takeover_step=3, mi_opt_steps=2, scene_scale=1.0, object_aabb=BOX, tsdf_init_res=16,
        tsdf_depth_downscale=2, batch_size=2, spp=2, spp_attached=0, takeover_image_size=8,
        distill_emitter=True, distill_steps=2)
    opt_cfg = topt.SdfOptConfig(
        name="tiny", bsdf_type=0, loss="relative_l1",
        variables=(topt.VariableSpec("sdf", lr=3e-3, redistance_freq=0),
                   topt.VariableSpec("albedo", lr=1e-2, clamp=(0.0, 1.0)),
                   topt.VariableSpec("roughness", lr=0.0, clamp=(0.02, 1.0))),
        init_res=17, tex_res=4, render_upsample_iter=(), curvature_mult=0.0)
    pipe = tne.NerfEmitterPipeline(
        cfg, model, TT.TrainConfig(num_rays_per_batch=64, far=3.0, max_steps=20, anneal_steps=5), opt_cfg, ds,
        render_config=RenderConfig(trace=SphereTraceConfig(max_steps=16, t_max=3.0)), mesh=mesh,
        data_axis=None if mesh is None else pm.DATA_AXIS)
    pipe.guiding.downscale, pipe.guiding.n_clusters, pipe.guiding.max_points = 8, 4, 256
    g = torch.Generator().manual_seed(0)
    nerf_view = pipe.render_camera_outputs(ds, 1, torch.Generator().manual_seed(5), spp=2)
    metrics = [{k: float(v) for k, v in pipe.train_iteration(step, g).items()} for step in range(5)]
    return pipe, ds, model, nerf_view, metrics


def s_pipeline(mesh, inp) -> dict:
    """two_phase, then a view: sharded, and on this rank alone."""
    pipe, ds, model, nerf_view, metrics = two_phase(mesh, inp)
    view = pipe.render_camera_outputs(ds, 0, torch.Generator().manual_seed(9), spp=2)
    alone = pipe.render_camera_outputs(ds, 0, torch.Generator().manual_seed(9), spp=2, collective=False)
    probe = query_rays(16)
    with torch.no_grad():
        served = pipe._takeover_emitter_fn(torch.full((16, 3), 0.5), probe.directions)
    drift = {"nerf": pm.max_replica_difference(model, mesh), "sdf": pm.max_replica_difference(pipe.sdf_state, mesh),
             "student": pm.max_replica_difference(served, mesh)}
    return dict(metrics=metrics, nerf_view=nerf_view, view=view, alone=alone, drift=drift,
                guiding=pipe.sdf_state.scene.guiding.positions)


SCENARIOS = {"rows": s_rows, "nerf_step": s_nerf_step, "render": s_render, "query": s_query,
             "takeover_exact": s_takeover,
             "takeover_aggregate": functools.partial(s_takeover, spp=4, spp_attached=2, curvature=1e-3),
             "pipeline": s_pipeline}


def run_scenarios(mesh, inp) -> dict:
    os.environ["NERF_EMITTER_GRAD_BAND_BUDGET"] = "16"  # 2 bands of 2 rows at 4^2 x 2 attached samples
    # the distillation cut for the CPU (its default batch is 2^14)
    tne.DistillConfig = functools.partial(DISTILL_CONFIG, batch=1 << 8)
    return {name: fn(mesh, inp) for name, fn in SCENARIOS.items()}


DISTILL_CONFIG = tne.DistillConfig


def _rank(rank: int, world: int, port: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(NERF_EMITTER_COORDINATOR=f"127.0.0.1:{port}", NERF_EMITTER_NUM_PROCESSES=str(world),
                      NERF_EMITTER_PROCESS_ID=str(rank))
    assert pm.maybe_initialize_distributed("cpu")
    mesh = pm.make_mesh(device_type="cpu")
    assert mesh.backend == "gloo" and (mesh.rank, mesh.world_size) == (rank, world)
    try:
        torch.save(run_scenarios(mesh, torch.load(inputs)), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---- the parent: inputs, one spawn of the ranks, the one-rank run


def _close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """(inputs, JAX pieces, one-rank results, [rank 0's, rank 1's])."""
    import jax
    from test_torch_hash import hash_pair
    from test_torch_train import freq_pair

    root = tmp_path_factory.mktemp("ranks")
    jm, jparams, hash_model = hash_pair()
    fjm, fparams, freq_model = freq_pair()
    torch.manual_seed(0)
    takeover_model = NerfactoModel(AABB, device="cpu", num_nerf_samples=4, num_proposal_samples=(8,),
                                   log2_hashmap_size=10, max_res=32, num_cameras=2, appearance_embedding_dim=4)
    inp = {"hash": hash_model.state_dict(), "freq": freq_model.state_dict(),
           "takeover_model": takeover_model.state_dict()}
    torch.save(inp, root / "inputs.pt")
    mp.spawn(_rank, args=(WORLD, free_port(), str(root / "inputs.pt"), str(root)), nprocs=WORLD, join=True)
    ranks = [torch.load(root / f"rank{r}.pt") for r in range(WORLD)]
    saved = tne.DistillConfig
    try:
        one = run_scenarios(None, torch.load(root / "inputs.pt"))
    finally:
        tne.DistillConfig = saved
        os.environ.pop("NERF_EMITTER_GRAD_BAND_BUDGET", None)
    return inp, dict(hash=(jm, jparams), freq=(fjm, fparams), jax=jax), one, ranks


def test_rows_shard_and_gather_with_padding(runs):
    """7 rows over 2 ranks: 4 each, the second's last row the padding (the
    last real row repeated); the gather gives the 7 rows back on both
    ranks, and its gradient reaches x through both ranks' rows (2 w).
    shard_leading_axis splits the 8-row tensor, keeps the 7-row one;
    replicated makes rank 1's value rank 0's."""
    _, _, one, ranks = runs
    one, ranks = one["rows"], [r["rows"] for r in ranks]
    x = torch.arange(21, dtype=torch.float32).reshape(7, 3)
    w = torch.linspace(-1.0, 1.0, 21).reshape(7, 3)
    assert torch.equal(ranks[0]["local"], x[:4]) and torch.equal(ranks[1]["local"], torch.cat([x[4:], x[6:]]))
    for r in (*ranks, one):
        assert torch.equal(r["gathered"], 2 * x) and torch.equal(r["grad"], 2 * w)
    assert torch.equal(ranks[0]["even"], torch.arange(4.0)) and torch.equal(ranks[1]["even"], torch.arange(4.0, 8.0))
    assert all(torch.equal(r["odd"], torch.arange(7.0)) for r in ranks)
    assert ranks[0]["before"] == 1.0 and ranks[0]["after"] == ranks[1]["after"] == 0.0
    assert torch.equal(ranks[1]["own"], torch.zeros(3))


def test_sharded_nerf_train_step_matches_one_rank(runs):
    """One step, as tests/test_multichip.py's: every parameter within rtol
    2e-4, atol 1e-6 of one rank's and equal on both ranks; that step's
    loss and the next step's on both ranks equal and within rtol 1e-5 of
    one rank's. (A second Adam step is not held at the parameter bar:
    Adam normalises each entry's gradient, and the ranks' partial sums
    round a near-cancelling hash-grid gradient differently.)"""
    _, _, one, ranks = runs
    for r in ranks:
        _close(r["nerf_step"]["losses"], one["nerf_step"]["losses"], 1e-5, 0)
        for k, v in one["nerf_step"]["params"].items():
            _close(r["nerf_step"]["params"][k], v, 2e-4, 1e-6, k)
            assert torch.equal(r["nerf_step"]["params"][k], ranks[0]["nerf_step"]["params"][k]), k
    assert ranks[0]["nerf_step"]["losses"] == ranks[1]["nerf_step"]["losses"]


def test_sharded_eval_render_matches_jax(runs):
    """make_render_fn with chunks of 24 rays a rank (48 a chunk, the last
    part-filled) against JAX's make_render_fn at the same weights
    (rtol 1e-4, atol 1e-5, tests/test_torch_train.py's bar) and against
    one rank's (rtol 2e-4, atol 1e-6)."""
    from nerf_emitter_tpu.cameras.cameras import Cameras as JCameras
    from nerf_emitter_tpu.engine import train_loop as JT

    _, refs, one, ranks = runs
    jnp = refs["jax"].numpy
    jm, params = refs["hash"]
    c2w, f = ring_cameras(3, 8)
    jc = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.full((3,), f), fy=jnp.full((3,), f),
                  cx=jnp.full((3,), 4.0), cy=jnp.full((3,), 4.0), width=8, height=8)
    want = JT.make_render_fn(jm, JT.TrainConfig(far=3.0), chunk=24)(params, jc, jnp.int32(1), 8, 8)
    for r in ranks:
        for k in ("rgb", "depth", "accumulation"):
            _close(r["render"][k], want[k], 1e-4, 1e-5, k)
            _close(r["render"][k], one["render"][k], 2e-4, 1e-6, k)


def test_shard_fused_query_matches_jax_shard_map(runs):
    """The kernel query's plain twin split over 2 ranks (64 rays) against
    JAX's _shard_fused_query of its megakernel query on the 8-device CPU
    mesh (interpret mode) at the same weights (rtol 2e-3, atol 2e-4); its
    gradient with respect to the NeRF parameters is one rank's, the same
    parameters with one: the f32 parameters' within rtol 1e-5, atol 1e-7,
    the MLP weights' (the twin's weights are cast to bf16, so each rank's
    partial weight gradient is rounded to bf16) within 2 bf16 ulps of the
    largest entry."""
    from nerf_emitter_tpu.cameras.rays import RayBundle as JRayBundle
    from nerf_emitter_tpu.ops.mega_query import make_mega_radiance_query as j_mega
    from nerf_emitter_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from nerf_emitter_tpu.pipelines.nerf_emitter import _shard_fused_query

    _, refs, one, ranks = runs
    jax = refs["jax"]
    fjm, fparams = refs["freq"]
    r = query_rays()
    jr = JRayBundle(**{f.name: jax.numpy.asarray(getattr(r, f.name).numpy().astype(
        np.int32 if f.name == "camera_indices" else np.float32)) for f in dataclasses.fields(r)
        if getattr(r, f.name) is not None})
    want = np.asarray(jax.jit(_shard_fused_query(j_mega(fjm), make_mesh(8), DATA_AXIS))(fparams, jr))
    for rank in ranks:
        assert rank["query"]["out"].shape == (QUERY_RAYS, 3)
        _close(rank["query"]["out"], want, 2e-3, 2e-4)
        assert set(rank["query"]["grads"]) == set(one["query"]["grads"]) and one["query"]["grads"]
        for k, g in one["query"]["grads"].items():
            bf16 = "mlp" in k and k.endswith(".weight")
            _close(rank["query"]["grads"][k], g, 0 if bf16 else 1e-5, 2**-7 * float(g.abs().max()) if bf16 else 1e-7,
                   k)


@pytest.mark.parametrize("mode", ["takeover_exact", "takeover_aggregate"])
def test_sharded_takeover_step_matches_one_rank(runs, mode):
    """Two takeover steps (exact at spp 1; aggregate at spp 4 with 2
    attached in 2 gradient bands and the curvature term on): the metrics
    within rtol 1e-5 of one rank's, the SDF and albedo grids within rtol
    2e-4, atol 1e-6, and equal on both ranks."""
    _, _, one, ranks = runs
    want = one[mode]
    assert ranks[0][mode]["bands"] == want["bands"] == (2 if mode == "takeover_aggregate" else 1)
    for r in ranks:
        for got, ref in zip(r[mode]["metrics"], want["metrics"]):
            assert set(got) == set(ref)
            for k in ("loss", "view_loss", "mask_loss", "curvature", "laplacian"):
                _close(got[k], ref[k], 1e-5, 1e-9, k)
        for k in ("sdf", "albedo"):
            _close(r[mode][k], want[k], 2e-4, 1e-6, k)
            assert torch.equal(r[mode][k], ranks[0][mode][k]), k


def test_pipeline_sharded_view_matches_one_rank(runs):
    """render_camera_outputs through the pipeline: the NeRF's view before
    the takeover against one rank's, and after it the sharded view against
    the same view on one rank of the same state (rtol 2e-4, atol 1e-6)."""
    _, _, one, ranks = runs
    for r in ranks:
        for k in ("rgb", "depth", "accumulation"):
            _close(r["pipeline"]["nerf_view"][k], one["pipeline"]["nerf_view"][k], 2e-4, 1e-6, k)
        assert set(r["pipeline"]["view"]) == {"rgb", "depth", "normal", "accumulation"}
        for k, v in r["pipeline"]["alone"].items():
            assert v.shape == r["pipeline"]["view"][k].shape
            _close(r["pipeline"]["view"][k], v, 2e-4, 1e-6, k)


def test_pipeline_replicas_stay_equal(runs):
    """After the two phases the NeRF, the SDF state and the distilled
    cache's answers are the same on both ranks (max difference 0); the
    first two NeRF steps' losses within rtol 1e-5 of one rank's (the
    third's follows two Adam steps, see the train step's test), every
    takeover metric finite, the guiding mixture on both ranks rank 0's."""
    _, _, one, ranks = runs
    for r in ranks:
        assert r["pipeline"]["drift"] == {"nerf": 0.0, "sdf": 0.0, "student": 0.0}
        _close([m["loss"] for m in r["pipeline"]["metrics"][:2]], [m["loss"] for m in one["pipeline"]["metrics"][:2]],
               1e-5, 0)
        assert all(np.isfinite(v) for m in r["pipeline"]["metrics"] for v in m.values())
        assert "view_loss" in r["pipeline"]["metrics"][-1]
    assert torch.equal(ranks[0]["pipeline"]["guiding"], ranks[1]["pipeline"]["guiding"])


def test_kernel_query_backward_recomputes_in_chunks(monkeypatch):
    """A kernel query of more than RECOMPUTE_RAYS rays recomputes its
    backward in chunks of exactly that many, the last padded with K5's pad
    values (so a ray's gradient does not depend on the batch it was asked
    in; on the card the sharded takeover step rests on it). On the plain
    twin, 200 rays in chunks of 64: the gradients with respect to the
    rays equal one pass's (rtol 1e-5, atol 1e-7), the field MLPs' within 2
    bf16 ulps of the largest entry (each chunk's is rounded to bf16, as
    the reference rounds a Dense layer's)."""
    from nerf_emitter_tpu_torch.ops import mega_query

    torch.manual_seed(0)
    model = NerfactoModel(AABB, device="cpu", **FREQ)
    query = make_mega_radiance_query(model, device="cpu")
    rays = query_rays(200)
    weights = torch.linspace(0.5, 1.5, 600).reshape(200, 3)

    def grads():
        o, d = rays.origins.clone().requires_grad_(), rays.directions.clone().requires_grad_()
        params = {k: v.detach().clone().requires_grad_() for k, v in named_params(model).items()}
        out = query(params, dataclasses.replace(rays, origins=o, directions=d))
        names = [k for k in sorted(params) if k.startswith("field.")]
        return torch.autograd.grad((out * weights).sum(), [o, d, *[params[k] for k in names]]), names

    want, names = grads()
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", 64)
    got, _ = grads()
    for name, a, b in zip(["origins", "directions", *names], got, want):
        bf16 = "mlp" in name
        _close(a, b, 0 if bf16 else 1e-5, 2**-7 * float(b.abs().max()) if bf16 else 1e-7, name)
