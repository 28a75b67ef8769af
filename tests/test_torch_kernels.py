"""The plain twins of the port's first four kernels against the JAX package's
Pallas kernels (interpret mode on the CPU) on the same inputs and weights.

K1 `fused_density` and K2 `fused_field`: through the JAX custom_vjp
functions. K3 and K4: the JAX kernel bodies `_proposal_kernel` and
`_field_composite_kernel`, launched through pl.pallas_call as the JAX
package's two-kernel query (`make_mega_radiance_query(pipelined=False)`)
launches them; the port reaches K4 by calling it on K3's bins.

The twins repeat the TPU kernels' arithmetic (bf16 operands, f32
accumulation and bias, the <=4-wide output layer as an f32 reduce with the
f32 weight), so the bar is tight: f32 sums taken in another order can flip
a bf16 rounding of a hidden unit now and then (rtol 2e-3). JAX's own
`_plain_density`/`_plain_field` twins round that last weight to bf16
instead; against them the port agrees only to that rounding (rtol 2e-2).
On the card the CUDA kernels are held against these twins by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.ops import fused_field as jff
from nerf_emitter_tpu.ops import mega_query as jmq
from nerf_emitter_tpu_torch.ops import fused_field as tff
from nerf_emitter_tpu_torch.ops import mega_query as tmq
from nerf_emitter_tpu_torch.ops.resample import resample

torch.set_num_threads(1)

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
ALO, AINV = (-1.5,) * 3, (1.0 / 3.0,) * 3
BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
S0, S1, S2 = 12, 8, 6


@functools.lru_cache(maxsize=1)
def _tree():
    """One JAX model.init of the small freq model, as numpy."""
    from nerf_emitter_tpu.cameras.rays import RayBundle

    jm = JModel(aabb=AABB, num_nerf_samples=S2, num_proposal_samples=(S0, S1), num_cameras=4,
                appearance_embedding_dim=8, implementation="freq")
    n = 4
    rays = RayBundle(origins=jnp.zeros((n, 3)), directions=jnp.ones((n, 3)) / np.sqrt(3.0),
                     pixel_area=jnp.full((n, 1), 1e-4), nears=jnp.full((n, 1), 0.05),
                     fars=jnp.full((n, 1), 3.0), camera_indices=jnp.zeros((n, 1), jnp.int32))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7), rays))["params"]


def _mlp(path):
    """(ws, bs) as numpy (in, out) / (out,)."""
    node = _tree()
    for k in path.split("/"):
        node = node[k]
    ws, bs = jff._mlp_params(node)
    return [np.asarray(w) for w in ws], [np.asarray(b) for b in bs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _close(t, j, rtol, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _positions(m, seed):
    return np.random.default_rng(seed).uniform(-1.7, 1.7, size=(3, m)).astype(np.float32)


def _dirs(m, seed):
    d = np.random.default_rng(seed).normal(size=(3, m)).astype(np.float32)
    return d / np.linalg.norm(d, axis=0, keepdims=True)


@pytest.mark.parametrize("level,box", [(0, None), (1, BOX)], ids=["F4", "F6_carveout"])
def test_k1_density_twin_matches_pallas(level, box):
    ws, bs = _mlp(f"proposal_{level}/mlp")
    freqs = jff._freqs_of(ws[0])
    pos = _positions(1000, seed=level)
    ref = jff.fused_density(jnp.asarray(pos), _j(ws), _j(bs), freqs, ALO, AINV, box, 1.0)
    out = tff.fused_density(torch.from_numpy(pos), _t(ws), _t(bs), freqs, ALO, AINV, box, 1.0)
    _close(out, ref, rtol=2e-3, atol=1e-6)
    plain = jff._plain_density(jnp.asarray(pos), _j(ws), _j(bs), num_freqs=freqs, aabb_lo=ALO,
                               aabb_inv_ext=AINV, disable_box=box, avg_density=1.0)
    _close(out, plain, rtol=2e-2, atol=1e-5)
    if box is not None:
        inside = np.all((pos.T > BOX[0]) & (pos.T < BOX[1]), axis=-1)
        assert inside.any() and np.all(out.numpy()[inside] == 0.0)


@pytest.mark.parametrize("box", [None, BOX], ids=["nobox", "carveout"])
def test_k2_field_twin_matches_pallas(box):
    bws, bbs = _mlp("field/base_mlp")
    hws, hbs = _mlp("field/head_mlp")
    emb = _tree()["field"]["appearance_embedding"]["embedding"][2]
    pos, dirs = _positions(500, seed=3), _dirs(500, seed=4)
    args = (10, ALO, AINV, box, 1.0)
    jd, jrgb = jff.fused_field(jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(emb), _j(bws), _j(bbs),
                               _j(hws), _j(hbs), *args, 15, True, 0.0)
    td, trgb = tff.fused_field(torch.from_numpy(pos), torch.from_numpy(dirs), torch.from_numpy(emb),
                               _t(bws), _t(bbs), _t(hws), _t(hbs), *args, True, 0.0)
    _close(td, jd, rtol=2e-3, atol=1e-6)
    _close(trgb, jrgb, rtol=2e-3, atol=1e-6)


def test_k1_k2_backward_recomputes_through_the_twins():
    """Gradients of the kernel wrappers w.r.t. positions and weights equal
    autograd through the twins themselves."""
    ws, bs = _mlp("proposal_0/mlp")
    pos = torch.from_numpy(_positions(300, seed=5)).requires_grad_()
    w = [t.requires_grad_() for t in _t(ws)]
    b = _t(bs)
    g1 = torch.autograd.grad(tff.fused_density(pos, w, b, 4, ALO, AINV, BOX, 1.0).square().sum(),
                             [pos, w[0]])
    g2 = torch.autograd.grad(tff._plain_density(pos, w, b, num_freqs=4, aabb_lo=ALO, aabb_inv_ext=AINV,
                                                disable_box=BOX, avg_density=1.0).square().sum(),
                             [pos, w[0]])
    for a, c in zip(g1, g2):
        torch.testing.assert_close(a, c)

    bws, bbs = _mlp("field/base_mlp")
    hws, hbs = _mlp("field/head_mlp")
    emb = torch.from_numpy(np.array(_tree()["field"]["appearance_embedding"]["embedding"][0]))
    dirs = torch.from_numpy(_dirs(300, seed=6))
    hw = [t.requires_grad_() for t in _t(hws)]
    dens, rgb = tff.fused_field(pos, dirs, emb, _t(bws), _t(bbs), hw, _t(hbs), 10, ALO, AINV, None, 1.0,
                                True, 0.0)
    g = torch.autograd.grad((dens.sum() + rgb.sum()), [pos, hw[-1]])
    pd, prgb = tff._plain_field(pos, dirs, emb, _t(bws), _t(bbs), hw, _t(hbs), num_freqs=10,
                                aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=None, avg_density=1.0,
                                hdr=True, rgb_bias=0.0)
    gp = torch.autograd.grad((pd.sum() + prgb.sum()), [pos, hw[-1]])
    for a, c in zip(g, gp):
        torch.testing.assert_close(a, c)


def _ray_rows(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(3, n)).astype(np.float32)
    near = np.full((1, n), 0.05, np.float32)
    far = np.full((1, n), 3.0, np.float32)
    return o, d, near, far


def _tile(rows):
    return pl.BlockSpec((rows, jmq.TILE_RAYS), lambda i: (0, i))


def _full(shape):
    return pl.BlockSpec(shape, lambda i, _r=len(shape): (0,) * _r)


def _perm(ws, freqs):
    perm = np.asarray(jff.fmajor_permutation(freqs))
    return [ws[0][perm]] + ws[1:]


def _jax_proposal(rows, box):
    """JAX `_proposal_kernel` through pl.pallas_call (interpret), as the
    two-kernel mega query launches it."""
    ws0, bs0 = _mlp("proposal_0/mlp")
    ws1, bs1 = _mlp("proposal_1/mlp")
    ws0, ws1 = _perm(ws0, 4), _perm(ws1, 6)
    n = rows[0].shape[1]
    kern = functools.partial(
        jmq._proposal_kernel, n_w0=len(ws0), n_w1=len(ws1), s0=S0, s1=S1, s2=S2, freqs0=4, freqs1=6,
        aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=box, avg_density=1.0,
    )
    out = pl.pallas_call(
        kern, grid=(n // jmq.TILE_RAYS,),
        in_specs=[_tile(3), _tile(3), _tile(1), _tile(1),
                  *[_full(w.shape) for w in ws0], *[_full(b.shape) for b in bs0],
                  *[_full(w.shape) for w in ws1], *[_full(b.shape) for b in bs1]],
        out_specs=_tile(S2 + 1),
        out_shape=jax.ShapeDtypeStruct((S2 + 1, n), jnp.float32),
        interpret=True,
    )(*_j(rows), *_j(ws0), *_j(bs0), *_j(ws1), *_j(bs1))
    return np.asarray(out), (ws0, bs0, ws1, bs1)


@pytest.mark.parametrize("box", [None, BOX], ids=["nobox", "carveout"])
def test_k3_proposal_twin_matches_pallas(box):
    """Spacing bins (in [0, 1]) after both levels' resample. The TPU kernel
    sums telescoped ramps (~1e-4 of cancellation error); the port
    interpolates within the segment. The final bins also depend on the
    level-1 densities at the level-0 bins: redoing only the resample in
    float64 moves them by 2e-4 on these inputs, so the bar is 1e-3."""
    rows = _ray_rows(jmq.TILE_RAYS, seed=8)
    ref, (ws0, bs0, ws1, bs1) = _jax_proposal(rows, box)
    out = tmq.proposal_bins(*_t(rows), _t(ws0), _t(bs0), _t(ws1), _t(bs1), s0=S0, s1=S1, s2=S2,
                            freqs0=4, freqs1=6, aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=box,
                            avg_density=1.0)
    assert out.shape == (S2 + 1, jmq.TILE_RAYS)
    _close(out, ref, rtol=0.0, atol=1e-3)
    assert np.all(np.diff(out.numpy(), axis=0) >= 0.0)


@pytest.mark.parametrize("box", [None, BOX], ids=["nobox", "carveout"])
def test_k4_field_composite_twin_matches_pallas(box):
    """On the bins the JAX proposal kernel gives: the composite rgb."""
    rows = _ray_rows(jmq.TILE_RAYS, seed=9)
    sbins, _ = _jax_proposal(rows, box)
    bws, bbs = _mlp("field/base_mlp")
    hws, hbs = _mlp("field/head_mlp")
    bws = _perm(bws, 10)
    emb = np.array(_tree()["field"]["appearance_embedding"]["embedding"][1])
    n = rows[0].shape[1]
    kern = functools.partial(
        jmq._field_composite_kernel, n_base=len(bws), n_head=len(hws), n_emb=emb.shape[0], s2=S2,
        freqs=10, aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=box, avg_density=1.0, hdr=True,
        rgb_bias=0.0,
    )
    ref = pl.pallas_call(
        kern, grid=(n // jmq.TILE_RAYS,),
        in_specs=[_tile(S2 + 1), _tile(3), _tile(3), _tile(1), _tile(1), _full((1, emb.shape[0])),
                  *[_full(w.shape) for w in bws], *[_full(b.shape) for b in bbs],
                  *[_full(w.shape) for w in hws], *[_full(b.shape) for b in hbs]],
        out_specs=_tile(3),
        out_shape=jax.ShapeDtypeStruct((3, n), jnp.float32),
        interpret=True,
    )(jnp.asarray(sbins), *_j(rows), jnp.asarray(emb[None]), *_j(bws), *_j(bbs), *_j(hws), *_j(hbs))
    out = tmq.field_composite(torch.from_numpy(sbins), *_t(rows), torch.from_numpy(emb), _t(bws), _t(bbs),
                              _t(hws), _t(hbs), s2=S2, freqs=10, aabb_lo=ALO, aabb_inv_ext=AINV,
                              disable_box=box, avg_density=1.0, hdr=True, rgb_bias=0.0)
    assert out.shape == (3, n)
    _close(out, ref, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("kernel", ["fused_density", "fused_field", "proposal_bins", "field_composite",
                                    "mega_pipeline", "proposal_variant", "resample"])
def test_wrappers_use_the_twin_only_on_the_cpu(kernel):
    """A tensor that is not on the CPU goes to the kernel, never to the
    twin: on a device that has no kernel the wrapper raises."""
    meta = torch.device("meta")
    pos = torch.empty(3, 64, device=meta)
    ws, bs = (_t(x) for x in _mlp("proposal_0/mlp"))
    rows = [torch.empty(3, 128, device=meta), torch.empty(3, 128, device=meta),
            torch.empty(1, 128, device=meta), torch.empty(1, 128, device=meta)]
    bws, bbs = (_t(x) for x in _mlp("field/base_mlp"))
    hws, hbs = (_t(x) for x in _mlp("field/head_mlp"))
    emb = torch.empty(8, device=meta)
    box = dict(aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=None, avg_density=1.0)
    calls = {
        "fused_density": lambda: tff.fused_density(pos, ws, bs, 4, ALO, AINV, None, 1.0),
        "fused_field": lambda: tff.fused_field(pos, pos, emb, bws, bbs, hws, hbs, 10, ALO, AINV, None,
                                               1.0, True, 0.0),
        "proposal_bins": lambda: tmq.proposal_bins(*rows, ws, bs, ws, bs, s0=S0, s1=S1, s2=S2,
                                                   freqs0=4, freqs1=4, **box),
        "field_composite": lambda: tmq.field_composite(torch.empty(S2 + 1, 128, device=meta), *rows, emb,
                                                       bws, bbs, hws, hbs, s2=S2, freqs=10, hdr=True,
                                                       rgb_bias=0.0, **box),
        "mega_pipeline": lambda: tmq.mega_pipeline(*rows, emb, ws, bs, ws, bs, bws, bbs, hws, hbs, s0=S0,
                                                   s1=S1, s2=S2, freqs0=4, freqs1=4, freqs=10, hdr=True,
                                                   rgb_bias=0.0, **box),
        "proposal_variant": lambda: tmq.proposal_variant(*rows, ws, bs, ws, bs, mode="dens-only", s0=S0,
                                                         s1=S1, s2=S2, freqs0=4, freqs1=4, **box),
        "resample": lambda: resample(torch.empty(S0, 128, device=meta), torch.empty(S0 + 1, 128, device=meta),
                                     pos, torch.empty(4, 64, device=meta), n_out=2, form="walk"),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[kernel]()


@pytest.mark.parametrize("far", [4.0, 1e3], ids=["far4", "far1e3"])
def test_background_sample_conditioning(far):
    """Why the emitter's tight parity bars are taken at far=4: with far=1e3
    the last (background) sample sits hundreds of units out, where the
    spacing warp 1/(2-2s) is so steep that a 1-ulp shift of the spacing
    bins moves the composite by more than the kernels' 1% bar. At far=4 the
    same shift stays well inside it (a bf16 rounding flip or two). At both,
    the answer without its background term (the foreground and the
    accumulation that K4's aux output splits off) stays inside it."""
    rows = list(_ray_rows(jmq.TILE_RAYS, seed=11))
    rows[3] = np.full_like(rows[3], far)
    sbins, _ = _jax_proposal(tuple(rows), None)
    bws, bbs = _mlp("field/base_mlp")
    hws, hbs = _mlp("field/head_mlp")
    emb = torch.from_numpy(np.array(_tree()["field"]["appearance_embedding"]["embedding"][1]))
    kw = dict(s2=S2, freqs=10, aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=None, avg_density=1.0,
              hdr=True, rgb_bias=0.0)
    sb = torch.from_numpy(np.array(sbins))
    args = (*_t(rows), emb, _t(_perm(bws, 10)), _t(bbs), _t(hws), _t(hbs))
    out, aux = tmq.field_composite(sb, *args, **kw, with_aux=True)
    moved, aux_m = tmq.field_composite(torch.nextafter(sb, torch.full_like(sb, 2.0)), *args, **kw,
                                       with_aux=True)

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp(min=1e-3)).max())

    if far < 10.0:
        assert rel(moved, out) < 1e-2
    else:
        assert rel(moved, out) > 1e-2  # if this ever fails, the far=1e3 bars can tighten
    torch.testing.assert_close(out, tmq.field_composite(sb, *args, **kw), rtol=0.0, atol=0.0)
    fg, fg_m = out - aux[1:] * (1.0 - aux[:1]), moved - aux_m[1:] * (1.0 - aux_m[:1])
    assert rel(fg_m, fg) < 1e-2 and rel(aux_m[0], aux[0]) < 1e-2


def test_fmajor_permutation_matches():
    for f in (4, 6, 10):
        assert tff.fmajor_permutation(f) == jff.fmajor_permutation(f)
        x2 = np.random.default_rng(f).uniform(-1, 1, size=(3, 7)).astype(np.float32)
        k = tff._freq_rows(torch.from_numpy(x2), f)
        fm = tff._freq_rows_fmajor(torch.from_numpy(x2), f)
        torch.testing.assert_close(fm, k[tff.fmajor_permutation(f)])
        # the recurrence doubles a 1-ulp difference of the base sin 9 times
        _close(k, jff._freq_rows(jnp.asarray(x2), f), rtol=1e-5, atol=1e-4)
