"""The proposal stage of K3 and K5 (csrc/emitter_query.cuh, csrc/proposal.cu,
csrc/mega_pipeline.cu), on the CPU: the kernels' summation order (32-lane
warp scans, a butterfly sum, a lane-strided binary search) emulated in
torch and held against the JAX package's `_proposal_kernel` (Pallas,
interpret mode); the rows of the density tiles (`ProposalIo`); the shared
memory of K3 and K5; the density packs of the main path's proposals; and
that the block-wide wmma MLP is gone. The kernels themselves run on the
card only (chip_smoke.py holds them against the twins)."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.ops import fused_field as jff
from nerf_emitter_tpu.ops import mega_query as jmq
from nerf_emitter_tpu_torch import kernels
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops import fused_field as tff
from nerf_emitter_tpu_torch.ops import mega_query as tmq
from nerf_emitter_tpu_torch.ops.samplers import spacing_piecewise, spacing_piecewise_inv

torch.set_num_threads(1)

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
ALO, AINV = (-1.5,) * 3, (1.0 / 3.0,) * 3
BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
S0, S1, S2 = 12, 8, 6
LANES = 32


# ---------------------------------------------------------------------------
# the JAX kernel A on a small model (as tests/test_torch_kernels.py runs it)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _tree():
    from nerf_emitter_tpu.cameras.rays import RayBundle

    jm = JModel(aabb=AABB, num_nerf_samples=S2, num_proposal_samples=(S0, S1), num_cameras=4,
                appearance_embedding_dim=8, implementation="freq")
    n = 4
    rays = RayBundle(origins=jnp.zeros((n, 3)), directions=jnp.ones((n, 3)) / np.sqrt(3.0),
                     pixel_area=jnp.full((n, 1), 1e-4), nears=jnp.full((n, 1), 0.05),
                     fars=jnp.full((n, 1), 3.0), camera_indices=jnp.zeros((n, 1), jnp.int32))
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7), rays))["params"]


def _mlp(level, freqs):
    """Proposal `level`'s (ws, bs) as numpy, first-layer rows f-major."""
    ws, bs = jff._mlp_params(_tree()[f"proposal_{level}"]["mlp"])
    ws, bs = [np.asarray(w) for w in ws], [np.asarray(b) for b in bs]
    return [ws[0][np.asarray(jff.fmajor_permutation(freqs))]] + ws[1:], bs


def _ray_rows(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(3, n)).astype(np.float32)
    return o, d, np.full((1, n), 0.05, np.float32), np.full((1, n), 3.0, np.float32)


def _jax_proposal(rows, props, box):
    (ws0, bs0), (ws1, bs1) = props
    n = rows[0].shape[1]
    tile = lambda r: pl.BlockSpec((r, jmq.TILE_RAYS), lambda i: (0, i))  # noqa: E731
    full = lambda s: pl.BlockSpec(s, lambda i, _r=len(s): (0,) * _r)  # noqa: E731
    kern = functools.partial(
        jmq._proposal_kernel, n_w0=len(ws0), n_w1=len(ws1), s0=S0, s1=S1, s2=S2, freqs0=4, freqs1=6,
        aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=box, avg_density=1.0,
    )
    wb = [*ws0, *bs0, *ws1, *bs1]
    return np.asarray(pl.pallas_call(
        kern, grid=(n // jmq.TILE_RAYS,),
        in_specs=[tile(3), tile(3), tile(1), tile(1), *[full(x.shape) for x in wb]],
        out_specs=tile(S2 + 1), out_shape=jax.ShapeDtypeStruct((S2 + 1, n), jnp.float32), interpret=True,
    )(*[jnp.asarray(x) for x in (*rows, *wb)]))


# ---------------------------------------------------------------------------
# the kernels' order of summation, in torch (rows: samples, columns: rays)
# ---------------------------------------------------------------------------


def _warp_incl(x):
    """emitter_query.cuh `warp_incl_sum` on (32, R): Hillis-Steele over the
    lanes, lane l adding lane l - off's value for off = 1, 2, 4, 8, 16."""
    for off in (1, 2, 4, 8, 16):
        x = x + torch.cat([torch.zeros_like(x[:off]), x[:-off]])
    return x


def _strip(x, base):
    """Lanes base .. base + 31 of (S, R), zero past S."""
    out = torch.zeros(LANES, x.shape[1], dtype=x.dtype)
    part = x[base:base + LANES]
    out[: part.shape[0]] = part
    return out


def _warp_weights(dens, deltas):
    """`ray_weights`: the exclusive cumsum of dd = dens * delta by 32-sample
    strips (the strip's scan shifted a lane, plus the strips before)."""
    dd = dens * deltas
    s, r = dd.shape
    carry, excl = torch.zeros(r), []
    for base in range(0, s, LANES):
        incl = _warp_incl(_strip(dd, base))
        before = torch.cat([torch.zeros(1, r), incl[:-1]])
        excl.append((carry + before)[: min(LANES, s - base)])
        carry = carry + incl[-1]
    return (1.0 - torch.exp(-dd)) * torch.exp(-torch.cat(excl))


def _warp_cdf(weights):
    """`build_cdf`: the padded weights' sum by lane partials (lane l over
    samples l, l + 32, ... in order) and a butterfly; the pdf's running sum
    by strips."""
    w = weights + 0.01
    s, r = w.shape
    part = torch.zeros(LANES, r)
    for base in range(0, s, LANES):
        part = part + _strip(w, base)
    lane = torch.arange(LANES)
    for m in (16, 8, 4, 2, 1):
        part = part + part[lane ^ m]
    assert torch.equal(part, part[:1].expand_as(part))  # every lane the same bits
    w_sum = part[0]
    padding = (1e-5 - w_sum).clamp(min=0.0)
    pdf = (w + padding / s) / (w_sum + padding)
    carry, incl = torch.zeros(r), []
    for base in range(0, s - 1, LANES):
        run = carry + _warp_incl(_strip(pdf[: s - 1], base))
        incl.append(run[: min(LANES, s - 1 - base)])
        carry = run[-1]
    return torch.cat([torch.zeros(1, r), torch.cat(incl).clamp(max=1.0), torch.ones(1, r)])


def _warp_resample(weights, sbins, n_out):
    """`inverse_cdf`: u_i's segment b by the kernel's binary search (the
    first k in [1, S) with cdf[k] > u, less one), then the twin's
    interpolation."""
    s = weights.shape[0]
    cdf = _warp_cdf(weights)
    step = (1.0 - 1e-5) / n_out
    u = torch.tensor([i * step + 1.0 / (2.0 * (n_out + 1)) for i in range(n_out + 1)],
                     dtype=torch.float32)[:, None].expand(n_out + 1, cdf.shape[1])
    lo = torch.ones(u.shape, dtype=torch.long)
    hi = torch.full(u.shape, s, dtype=torch.long)
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) // 2
        le = cdf.gather(0, mid.clamp(max=s)) <= u
        lo = torch.where(active & le, mid + 1, lo)
        hi = torch.where(active & ~le, mid, hi)
    b = lo - 1
    assert torch.equal(b, torch.searchsorted(cdf[1:s].T.contiguous(), u.T.contiguous(), right=True).T)
    c0, c1 = cdf.gather(0, b), cdf.gather(0, b + 1)
    sb0, sb1 = sbins.gather(0, b), sbins.gather(0, b + 1)
    frac = ((u - c0) / (c1 - c0).clamp(min=1e-5)).clamp(0.0, 1.0)
    return sb0 + (sb1 - sb0) * frac


def _warp_proposal(rows, props, box):
    """Both proposal levels with the twin's densities and the kernels' order
    of summation in the weights, the CDF and the resample."""
    o, d, near, far = (torch.from_numpy(x) for x in rows)
    s_near, s_far = spacing_piecewise(near), spacing_piecewise(far)
    kw = dict(aabb_lo=ALO, aabb_inv_ext=AINV, disable_box=box, avg_density=1.0)
    sbins = (torch.arange(S0 + 1, dtype=torch.float32) / float(S0))[:, None].expand(S0 + 1, o.shape[1])
    for (ws, bs), freqs, n_out in zip(props, (4, 6), (S1, S2)):
        ebins = spacing_piecewise_inv(sbins * (s_far - s_near) + s_near)
        dens = tmq._density_rows(ebins, o, d, [torch.from_numpy(np.array(w)) for w in ws],
                                 [torch.from_numpy(np.array(b)) for b in bs], num_freqs=freqs, **kw)
        sbins = _warp_resample(_warp_weights(dens, ebins[1:] - ebins[:-1]), sbins, n_out)
    return sbins


@pytest.mark.parametrize("box", [None, BOX], ids=["nobox", "carveout"])
def test_warp_order_proposal_matches_pallas(box):
    """The kernels' scans and search on both levels against the TPU kernel
    (interpret mode) at K3's twin-vs-Pallas bar (atol 1e-3 on spacing bins
    in [0, 1]); the bins stay monotone. The JAX kernel itself sums by a
    Hillis-Steele scan (`_cumsum_rows`)."""
    rows = _ray_rows(jmq.TILE_RAYS, seed=8)
    props = (_mlp(0, 4), _mlp(1, 6))
    ref = _jax_proposal(rows, props, box)
    out = _warp_proposal(rows, props, box)
    assert out.shape == (S2 + 1, jmq.TILE_RAYS)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0.0, atol=1e-3)
    assert np.all(np.diff(out.numpy(), axis=0) >= 0.0)


# ---------------------------------------------------------------------------
# the rows of the density tiles, shared memory, packs
# ---------------------------------------------------------------------------


def _row_map(n_rays, s):
    """The rows of a proposal level's density tiles for a group of n_rays
    rays of s samples, as `proposal_level` hands them to `ProposalIo`: per
    128-row pass, per 64-row warpgroup tile (rows c0 + 64 wg + row), the
    (ray, bin) that row encodes, or None past n_rays x s."""
    total = n_rays * s
    return [[[divmod(j, s) if j < total else None
              for j in range(c0 + wg * kernels.WG_ROWS, c0 + (wg + 1) * kernels.WG_ROWS)]
             for wg in range(kernels.PASS_ROWS // kernels.WG_ROWS)]
            for c0 in range(0, total, kernels.PASS_ROWS)]


@pytest.mark.parametrize("n_rays,s,passes", [(8, 256, 16), (8, 96, 6), (3, 256, 6), (3, 96, 3)],
                         ids=["full_level0", "full_level1", "part_filled_level0", "part_filled_level1"])
def test_proposal_row_map(n_rays, s, passes):
    """Row j of a level is ray j // S, bin j % S: every (ray, bin) of the
    group once, in passes of two 64-row warpgroup tiles; the rows past
    n_rays x S (the last group of 1003 rays holds 3) are written nowhere."""
    body = (Path(tmq.__file__).resolve().parent.parent / "csrc" / "emitter_query.cuh").read_text()
    assert "ProposalIo{bx, p.eb, p.ray, p.dens, c0 + wg * WG_ROWS, total, S, smax, F}" in body
    assert "const int r = j / S, s = j % S;" in body and "for (int c0 = 0; c0 < total; c0 += PASS_ROWS)" in body
    tiles = _row_map(n_rays, s)
    assert len(tiles) == passes == -(-n_rays * s // kernels.PASS_ROWS)
    rows = [row for pass_ in tiles for tile in pass_ for row in tile]
    assert all(len(tile) == kernels.WG_ROWS for pass_ in tiles for tile in pass_)
    assert rows[: n_rays * s] == [(j // s, j % s) for j in range(n_rays * s)]
    assert all(row is None for row in rows[n_rays * s:])
    assert len(rows) - n_rays * s < kernels.PASS_ROWS


@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_proposal_shared_memory(kernel):
    """At samples (256, 96, 48): K3 is the alignment slack, two packs (each
    17,424 bytes in an 18,432-byte room), the density block's work area
    (two 8 KB slabs, 128 keep flags, the mbarrier) and the proposal state of
    8 rays, 96,144 bytes, so two blocks fit an SM; K5's two packs fit the
    field's 65,536-byte slab region, and the whole fits a block. At 2000
    level-0 samples neither fits, and the query builder raises."""
    state = 4 * 8 * (4 * 257 + 256 + 8)
    assert kernels.proposal_state_bytes(256, 96, 48) == state == 41344
    work = 2 * 64 * 64 * 2 + 128 * 4 + 16
    assert kernels.DENSITY_WORK == work and kernels.DENSITY_PACK_SPAN == 18432 >= kernels.DENSITY_PACK_BYTES
    if kernel == "K3":
        got = kernels.proposal_smem_bytes(256, 96, 48)
        assert got == 1024 + 2 * 18432 + work + state == 96144
        assert 2 * (got + 1024) <= 233472  # two blocks, each with its 1 KB the runtime keeps
    else:
        got = kernels.mega_pipeline_smem_bytes(256, 96, 48)
        field = 1024 + kernels.FIELD_PRE + kernels.RING * kernels.STAGE_BYTES
        assert got == field + 2 * kernels.SLAB_BYTES + work + state + 4 * 8 * 48 * 3 == 228816
        assert 2 * kernels.DENSITY_PACK_SPAN <= 2 * kernels.SLAB_BYTES == 65536
    assert got <= kernels.SMEM_LIMIT == 232448
    size = kernels.proposal_smem_bytes if kernel == "K3" else kernels.mega_pipeline_smem_bytes
    assert size(2000, 96, 48) > kernels.SMEM_LIMIT
    model = NerfactoModel(AABB, num_nerf_samples=48, num_proposal_samples=(2000, 96), num_cameras=4,
                          appearance_embedding_dim=32, implementation="freq", device="cpu")
    with pytest.raises(ValueError, match="K3 needs .* shared memory at samples \\(2000, 96, 48\\)"):
        tmq.check_query_shapes(tff.named_params(model), 2000, 96, 48)


@functools.lru_cache(maxsize=1)
def _sdf_nerfacto():
    torch.manual_seed(0)
    return NerfactoModel(AABB, num_nerf_samples=48, num_proposal_samples=(256, 96), num_cameras=4,
                         appearance_embedding_dim=32, implementation="freq", device="cpu")


@pytest.mark.parametrize("level,freqs,inputs", [(0, 4, 27), (1, 6, 39)], ids=["F4", "F6"])
def test_density_packs_build_from_the_sdf_nerfacto_proposals(level, freqs, inputs):
    """Each proposal of the main path's model (3 + 6F -> 128 -> 1) packs, as
    K3's and K5's wrappers pack it, into one DensityPack: the f-major first
    layer's wgmma image, then the f32 hidden bias, output weight and output
    bias."""
    ws, bs = tff._mlp_params(tff.named_params(_sdf_nerfacto()), f"proposal_{level}.mlp")
    assert [tuple(w.shape) for w in ws] == [(inputs, 128), (128, 1)]
    ws = tff.permute_first([w.detach() for w in ws], freqs)
    pack = tmq._proposal_packs(ws, bs, ws, bs, torch.device("cpu"))[0]
    buf = pack.buffer
    assert buf.dtype == torch.uint8 and buf.numel() == kernels.DENSITY_PACK_BYTES == 17424
    image = kernels.DENSITY_K * kernels.DENSITY_N * 2
    assert torch.equal(buf[:image], kernels.pack_wgmma_layer(ws[0]).view(torch.uint8))
    tail = buf[image:].view(torch.float32)
    assert torch.equal(tail[:128], bs[0].detach()) and torch.equal(tail[128:256], ws[1][:, 0])
    assert torch.equal(tail[256:], torch.cat([bs[1].detach(), torch.zeros(3)]))


def test_no_wmma_mlp_is_left_in_the_port():
    """The proposal stages run on the wgmma density block: no wmma fragment,
    run_mlp or PackedMlp remains in the package, and K3, P2 and K5 reach
    density_tile through the shared proposal body."""
    root = Path(tmq.__file__).resolve().parent.parent
    for f in root.rglob("*"):
        if f.suffix in (".py", ".cu", ".cuh"):
            text = f.read_text()
            for word in ("wmma::", "run_mlp", "PackedMlp", "<mma.h>"):
                assert word not in text, (f, word)
    body = (root / "csrc" / "emitter_query.cuh").read_text()
    assert "density_tile(ds, ProposalIo{" in body
    for src in ("proposal.cu", "mega_pipeline.cu"):
        assert "proposal_group<" in (root / "csrc" / src).read_text()
