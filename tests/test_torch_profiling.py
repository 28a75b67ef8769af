"""The profiling kernels P2 and P3 against the JAX package's profiling
scripts, and the port's profiling entry points at a tiny size on the CPU.

P2 (`proposal_variant`): its twin in each mode against
scripts/profile_kernel_a.py `make_variant_kernel`, launched through
pl.pallas_call in interpret mode. P3 (`resample`): its ramp twin against
scripts/profile_resample.py `make_kernel(resample_scalar_u)` at the
script's own shapes (one 128-ray tile), and its walk twin against the
ramp. The reference scripts are loaded by file path."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.ops import fused_field as jff
from nerf_emitter_tpu_torch.ops import mega_query as tmq
from nerf_emitter_tpu_torch.ops import resample as tres
from nerf_emitter_tpu_torch.scripts import profile_kernel_a, profile_query, profile_resample
from nerf_emitter_tpu_torch.scripts.profiling import ProfileSetup, device_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
ALO, AINV = (-1.5,) * 3, (1.0 / 3.0,) * 3
S0, S1, S2 = 12, 8, 6
TILE = 128


def _script(name):
    """scripts/<name>.py of the JAX package's repo, loaded by file path."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _proposal_weights():
    """Both proposal MLPs of one JAX model.init, (in, out) numpy, first
    layers in f-major row order."""
    from nerf_emitter_tpu.cameras.rays import RayBundle

    jm = JModel(aabb=AABB, num_nerf_samples=S2, num_proposal_samples=(S0, S1), num_cameras=4,
                appearance_embedding_dim=8, implementation="freq")
    rays = RayBundle(origins=jnp.zeros((4, 3)), directions=jnp.ones((4, 3)) / np.sqrt(3.0),
                     pixel_area=jnp.full((4, 1), 1e-4), nears=jnp.full((4, 1), 0.05),
                     fars=jnp.full((4, 1), 6.0), camera_indices=jnp.zeros((4, 1), jnp.int32))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3), rays))["params"]
    out = []
    for level, freqs in ((0, 4), (1, 6)):
        ws, bs = jff._mlp_params(tree[f"proposal_{level}"]["mlp"])
        ws = [np.asarray(w) for w in ws]
        ws[0] = ws[0][np.asarray(jff.fmajor_permutation(freqs))]
        out += [ws, [np.asarray(b) for b in bs]]
    return out


def _profile_rays(seed):
    """The profiling scripts' rays at one tile: from the origin, unit
    directions, near 0.05, far 6."""
    d = np.random.default_rng(seed).normal(size=(3, TILE)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return (np.zeros((3, TILE), np.float32), d, np.full((1, TILE), 0.05, np.float32),
            np.full((1, TILE), 6.0, np.float32))


@pytest.mark.parametrize("mode", tmq.PROPOSAL_MODES)
def test_p2_variant_twin_matches_pallas(mode):
    """Each mode's twin against the reference script's variant kernel at
    K3's test bar (spacing bins in [0, 1], atol 1e-3: the TPU's ramp sum
    and the port's CDF walk differ by ~1e-4 of the spacing range)."""
    ref_mod = _script("profile_kernel_a")
    ws0, bs0, ws1, bs1 = _proposal_weights()
    rows = _profile_rays(seed=4)
    kern = ref_mod.make_variant_kernel(mode, n_w0=len(ws0), n_w1=len(ws1), s0=S0, s1=S1, s2=S2,
                                       freqs0=4, freqs1=6, aabb_lo=ALO, aabb_inv_ext=AINV)
    tile = lambda rows_: pl.BlockSpec((rows_, TILE), lambda i: (0, i))  # noqa: E731
    full = lambda shape: pl.BlockSpec(shape, lambda i, _r=len(shape): (0,) * _r)  # noqa: E731
    ref = pl.pallas_call(
        kern, grid=(1,),
        in_specs=[tile(3), tile(3), tile(1), tile(1),
                  *[full(w.shape) for w in ws0], *[full(b.shape) for b in bs0],
                  *[full(w.shape) for w in ws1], *[full(b.shape) for b in bs1]],
        out_specs=tile(S2 + 1), out_shape=jax.ShapeDtypeStruct((S2 + 1, TILE), jnp.float32),
        interpret=True,
    )(*[jnp.asarray(x) for x in (*rows, *ws0, *bs0, *ws1, *bs1)])
    t = lambda xs: [torch.from_numpy(np.array(x)) for x in xs]  # noqa: E731
    out = tmq.proposal_variant(*t(rows), t(ws0), t(bs0), t(ws1), t(bs1), mode=mode, s0=S0, s1=S1,
                               s2=S2, freqs0=4, freqs1=6, aabb_lo=ALO, aabb_inv_ext=AINV,
                               disable_box=None, avg_density=1.0)
    assert out.shape == (S2 + 1, TILE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0.0, atol=1e-3)
    assert np.all(np.diff(out.numpy(), axis=0) >= 0.0)
    if mode == "full":
        full_bins = tmq.proposal_bins(*t(rows), t(ws0), t(bs0), t(ws1), t(bs1), s0=S0, s1=S1, s2=S2,
                                      freqs0=4, freqs1=6, aabb_lo=ALO, aabb_inv_ext=AINV,
                                      disable_box=None, avg_density=1.0)
        torch.testing.assert_close(out, full_bins, rtol=0.0, atol=0.0)


def _resample_inputs(seed):
    """The reference script's inputs at one tile: weights uniform in
    [0, 0.01) over uniform spacing bins."""
    rng = np.random.default_rng(seed)
    s0, s1 = 256, 96
    w0 = (rng.uniform(size=(s0, TILE)) * 0.01).astype(np.float32)
    w1 = (rng.uniform(size=(s1, TILE)) * 0.01).astype(np.float32)
    sb0 = np.repeat(np.linspace(0.0, 1.0, s0 + 1, dtype=np.float32)[:, None], TILE, axis=1)
    sb1 = np.repeat(np.linspace(0.0, 1.0, s1 + 1, dtype=np.float32)[:, None], TILE, axis=1)
    return w0, sb0, w1, sb1


@pytest.mark.parametrize("weights", ["script", "peaked"])
def test_p3_resample_twins_match_pallas(weights):
    """The ramp twin against the script's `scalar-u` kernel at atol 2e-4:
    both are f32 sums of the same telescoped ramps in different orders, each
    within ~1e-4 of exact. The walk against the ramp at 2e-3. "peaked"
    multiplies the weights by up to 100 so the CDF has steep and flat
    segments."""
    ref_mod = _script("profile_resample")
    w0, sb0, w1, sb1 = _resample_inputs(seed=5)
    if weights == "peaked":
        rng = np.random.default_rng(6)
        w0 = (w0 * rng.uniform(0.0, 100.0, size=w0.shape) ** 2 / 100.0).astype(np.float32)
        w1 = (w1 * rng.uniform(0.0, 100.0, size=w1.shape) ** 2 / 100.0).astype(np.float32)
    tile = lambda rows: pl.BlockSpec((rows, TILE), lambda i: (0, i))  # noqa: E731
    ref = pl.pallas_call(
        ref_mod.make_kernel(ref_mod.resample_scalar_u), grid=(1,),
        in_specs=[tile(w0.shape[0]), tile(sb0.shape[0]), tile(w1.shape[0]), tile(sb1.shape[0])],
        out_specs=tile(ref_mod.S2 + 1), out_shape=jax.ShapeDtypeStruct((ref_mod.S2 + 1, TILE), jnp.float32),
        interpret=True,
    )(w0, sb0, w1, sb1)
    args = [torch.from_numpy(x) for x in (w0, sb0, w1, sb1)]
    ramp = tres.resample(*args, n_out=ref_mod.S2, form="ramp")
    walk = tres.resample(*args, n_out=ref_mod.S2, form="walk")
    assert ramp.shape == walk.shape == (ref_mod.S2 + 1, TILE)
    np.testing.assert_allclose(ramp.numpy(), np.asarray(ref), rtol=0.0, atol=2e-4)
    torch.testing.assert_close(walk, ramp, rtol=0.0, atol=2e-3)
    # sb1 is never read: any values give the same bins
    torch.testing.assert_close(tres.resample(*args[:3], torch.full_like(args[3], 7.0), form="walk"),
                               walk, rtol=0.0, atol=0.0)


def test_profiling_entry_points_run_on_the_cpu_at_a_tiny_size():
    """Each script's run() on the CPU (asked for explicitly) at a tiny size
    gives a positive time for every line the reference script prints."""
    s = ProfileSetup("cpu", num_rays=160, samples=(16, 8), nerf_samples=8)
    q = profile_query.run(s, iters=1)
    assert q["device"] == "cpu" and q["rays"] == 160
    assert all(t > 0 for t in (q["kernel_a_ms"], q["kernel_b_ms"], q["two_kernel_ms"], q["pipelined_ms"],
                               q["staged_ms"]))
    assert len(profile_query.report(q).splitlines()) == 8
    a = profile_kernel_a.run(s, iters=1)
    assert list(a["ms"]) == list(tmq.PROPOSAL_MODES) and all(t > 0 for t in a["ms"].values())
    r = profile_resample.run(profile_resample.inputs("cpu", num_rays=32), iters=1)
    assert list(r["ms"]) == list(tres.FORMS)
    assert r["max_abs_diff_vs_ramp"]["ramp"] == 0.0 and r["max_abs_diff_vs_ramp"]["walk"] < 2e-3
    assert "max |diff| vs ramp" in profile_resample.report(r)


@pytest.mark.parametrize("script", ["profile_query", "profile_kernel_a", "profile_resample"])
def test_profiling_entry_points_default_to_cuda(script):
    """device=None means CUDA; without a card the scripts raise instead of
    timing the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        if script == "profile_resample":
            profile_resample.inputs(num_rays=8)
        else:
            ProfileSetup(num_rays=8)


def test_device_trace_splits_the_window_on_the_cpu():
    """The trace helper profiles back-to-back calls and splits their window;
    on the CPU no device activity is recorded, so the device is idle all of
    the window."""
    a = torch.randn(64, 64)
    t = device_trace(lambda: (a @ a).sum(), calls=2)
    assert t["calls"] == 2 and t["window_ms"] > 0
    assert t["device_events"] == 0 and t["device_busy_ms"] == 0.0 and t["idle_share"] == 1.0
    assert t["device_ms_by_name"] == {} and t["gaps_ms"] == []
