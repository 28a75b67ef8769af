"""K1 on the wgmma density block (csrc/density_mlp.cuh) and K2 on the wgmma
field (csrc/field_mlp.cuh), on the CPU: K1's packed weights against the
(in, out) weights through a plain index map, the width checks the staged
and mega query builders run, the f-major encoding the kernels write
against the k-major twins, the launch shapes, and the mega query's
backward, which runs K1 and the field's twin but never K2. The kernels
themselves run on the card only (chip_smoke.py holds them against the
twins)."""

import collections
import functools

import numpy as np
import pytest
import torch

from nerf_emitter_tpu_torch import kernels
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.fields.nerfacto_field import HashMLPDensityField
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops import fused_field as tff
from nerf_emitter_tpu_torch.ops import mega_query as tmq

torch.set_num_threads(1)

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
CFG = dict(num_nerf_samples=8, num_proposal_samples=(16, 8), num_cameras=4, appearance_embedding_dim=8,
           implementation="freq", device="cpu")
KW = dict(aabb_lo=AABB[0], aabb_inv_ext=(1.0 / 3.0,) * 3, disable_box=BOX, avg_density=1.0)
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=1)
def _model():
    torch.manual_seed(0)
    return NerfactoModel(AABB, **CFG)


def _proposal(num_freqs, hidden=128, seed=0):
    """(ws, bs) of a proposal MLP over the F-octave encoding."""
    torch.manual_seed(seed)
    net = HashMLPDensityField(AABB, implementation="freq", freq_num_frequencies=num_freqs,
                              freq_hidden_dim=hidden, device="cpu")
    ws, bs = tff._mlp_params(dict(net.named_parameters()), "mlp")
    return [w.detach() for w in ws], [b.detach() for b in bs]


def _positions(m, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-1.7, 1.7, size=(3, m)).astype(np.float32))


def _bits(t: torch.Tensor, dtype) -> np.ndarray:
    return t.contiguous().numpy().view(dtype)


@pytest.mark.parametrize("num_freqs", [4, 6, 10], ids=["F4", "F6", "F10"])
def test_density_pack_matches_the_index_map(num_freqs):
    """DensityPack's buffer: the hidden layer's image puts W[kk, j] (bf16,
    f-major rows) at byte j * 128 + (((kk % 64) // 8) ^ (j % 8)) * 16 +
    (kk % 8) * 2, zero for the padded rows kk >= 3 + 6F; then the f32 hidden
    bias, the f32 output weight and the output bias in 16 bytes."""
    ws, bs = _proposal(num_freqs)
    ws = tff.permute_first(ws, num_freqs)
    buf = kernels.DensityPack(ws, bs, device=CPU).buffer
    assert buf.dtype == torch.uint8 and buf.numel() == kernels.DENSITY_PACK_BYTES == 17424
    k, n = ws[0].shape
    image = _bits(buf[: 64 * n * 2], np.int16)
    kk, j = np.meshgrid(np.arange(64), np.arange(n), indexing="ij")
    idx = (j * 128 + (((kk % 64) // 8) ^ (j % 8)) * 16 + (kk % 8) * 2) // 2
    assert np.unique(idx).size == 64 * n
    want = np.zeros((64, n), np.int16)
    want[:k] = ws[0].to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(image[idx], want)
    floats = _bits(buf[64 * n * 2:], np.float32)
    np.testing.assert_array_equal(floats[:n], bs[0].numpy())
    np.testing.assert_array_equal(floats[n:2 * n], ws[1][:, 0].numpy())
    np.testing.assert_array_equal(floats[2 * n:], [float(bs[1][0]), 0.0, 0.0, 0.0])


def test_check_density_widths_accepts_the_sdf_nerfacto_proposals():
    """Both proposal MLPs of the model (F=4 and F=6, one hidden layer of
    128) and an F=10 one (63 inputs) pass; the staged and mega queries
    build."""
    p = tff.named_params(_model())
    for lvl in range(2):
        kernels.check_density_widths([w.shape for w in tff._mlp_params(p, f"proposal_{lvl}.mlp")[0]])
    kernels.check_density_widths([w.shape for w in _proposal(10)[0]])
    tff.check_staged_shapes(p)
    assert callable(tff.make_fused_radiance_query(_model(), device="cpu").recompute)
    tmq.make_mega_radiance_query(_model(), device="cpu")


@pytest.mark.parametrize("shapes,match", [
    ([(27, 96), (96, 1)], "96 wide"),
    ([(69, 128), (128, 1)], "at most 64"),
    ([(27, 128), (128, 128), (128, 1)], "exactly one hidden layer"),
    ([(27, 128), (128, 2)], "output layer"),
], ids=["hidden96", "input69", "two_hidden", "out2"])
def test_check_density_widths_raises_on_what_it_cannot_take(shapes, match):
    with pytest.raises(ValueError, match=match):
        kernels.check_density_widths(shapes)


@pytest.mark.parametrize("builder", ["staged", "mega"])
@pytest.mark.parametrize("num_freqs,hidden,match", [(4, 96, "96 wide"), (11, 128, "at most 64")],
                         ids=["hidden96", "input69"])
def test_query_builders_raise_on_a_proposal_k1_does_not_take(builder, num_freqs, hidden, match):
    """A proposal MLP that K1's block does not take is refused when the
    query is built (the mega query's backward runs K1), on the CPU too."""
    torch.manual_seed(0)
    model = NerfactoModel(AABB, **CFG)
    model.proposal_1 = HashMLPDensityField(AABB, implementation="freq", freq_num_frequencies=num_freqs,
                                           freq_hidden_dim=hidden, device="cpu")
    build = tff.make_fused_radiance_query if builder == "staged" else tmq.make_mega_radiance_query
    with pytest.raises(ValueError, match=match):
        build(model, device="cpu")


def test_packs_raise_before_any_launch():
    """The packers the wrappers build before they launch refuse widths the
    kernels do not take: DensityPack a 96-wide proposal, FieldPack a 96-wide
    field."""
    with pytest.raises(ValueError, match="96 wide"):
        kernels.DensityPack(*_proposal(4, hidden=96), device=CPU)
    bws = [torch.zeros(63, 96), torch.zeros(96, 16)]
    bbs = [torch.zeros(96), torch.zeros(16)]
    hws = [torch.zeros(39, 64), torch.zeros(64, 3)]
    hbs = [torch.zeros(64), torch.zeros(3)]
    with pytest.raises(ValueError, match="hidden widths"):
        kernels.FieldPack(bws, bbs, hws, hbs, 8, device=CPU)


def _first_layer(enc, w):
    """The first layer's f32 pre-activation on bf16-rounded operands."""
    return enc.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


@pytest.mark.parametrize("num_freqs", [4, 6, 10], ids=["F4", "F6", "F10"])
def test_k1_fmajor_encoding_matches_the_kmajor_twin(num_freqs):
    """What K1 computes, the f-major encoding against `permute_first`
    weights, is the k-major twin: the first layer's pre-activation within
    f32 roundoff (the same products summed in another order), the density
    within a flipped bf16 rounding of a hidden unit now and then (rtol
    2e-3, the twins' bar against Pallas)."""
    ws, bs = _proposal(num_freqs, seed=num_freqs)
    pos = _positions(500, seed=num_freqs)
    x2, keep = tff._contract_and_select(pos, KW["aabb_lo"], KW["aabb_inv_ext"], BOX)
    enc_f, enc_k = tff._freq_rows_fmajor(x2, num_freqs).T, tff._freq_rows(x2, num_freqs).T
    wf = tff.permute_first(ws, num_freqs)
    torch.testing.assert_close(_first_layer(enc_f, wf[0]), _first_layer(enc_k, ws[0]), rtol=1e-5, atol=1e-5)
    dens_f = tff._density_of(tff._kernel_mlp(enc_f, wf, bs)[:, 0], keep, 1.0)
    dens_k = tff._plain_density(pos, ws, bs, num_freqs=num_freqs, **KW)
    torch.testing.assert_close(dens_f, dens_k, rtol=2e-3, atol=1e-6)


def test_k2_fmajor_encoding_matches_the_kmajor_twin():
    """The same for K2: the base MLP's first layer within f32 roundoff, the
    density and colour (the head's raw output through the HDR exp) at the
    twins' bar."""
    p = tff.named_params(_model())
    bws, bbs = [[t.detach() for t in x] for x in tff._mlp_params(p, "field.base_mlp")]
    hws, hbs = [[t.detach() for t in x] for x in tff._mlp_params(p, "field.head_mlp")]
    emb = p["field.appearance_embedding.weight"][1].detach()
    pos = _positions(400, seed=3)
    d = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 400)).astype(np.float32))
    d = d / d.norm(dim=0, keepdim=True)
    x2, keep = tff._contract_and_select(pos, KW["aabb_lo"], KW["aabb_inv_ext"], BOX)
    enc_f, enc_k = tff._freq_rows_fmajor(x2, 10).T, tff._freq_rows(x2, 10).T
    bwf = tff.permute_first(bws, 10)
    torch.testing.assert_close(_first_layer(enc_f, bwf[0]), _first_layer(enc_k, bws[0]), rtol=1e-5, atol=1e-5)
    sh = tff._sh4_rows(d).T
    base = tmq._plain_field_mlp(enc_f, sh, emb, bwf, bbs, hws, hbs, depth=len(bws))
    raw = tmq._plain_field_mlp(enc_f, sh, emb, bwf, bbs, hws, hbs)
    dens_k, rgb_k = tff._plain_field(pos, d, emb, bws, bbs, hws, hbs, num_freqs=10, hdr=True, rgb_bias=0.0, **KW)
    torch.testing.assert_close(tff._density_of(base[:, 0], keep, 1.0), dens_k, rtol=2e-3, atol=1e-6)
    torch.testing.assert_close(tff._rgb_of(raw, True, 0.0).T, rgb_k, rtol=2e-3, atol=1e-6)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return RayBundle(origins=torch.from_numpy(rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)),
                     directions=torch.from_numpy(d), pixel_area=torch.full((n, 1), 1e-4),
                     nears=torch.full((n, 1), 0.05), fars=torch.full((n, 1), 3.0),
                     camera_indices=torch.ones((n, 1), dtype=torch.long))


def test_mega_backward_runs_k1_twice_and_never_k2(monkeypatch):
    """The mega query's backward rebuilds the staged graph with K1 placing
    both levels' samples and the field through its twin: `fused_density`
    twice, `fused_field` never (its output would go unread). The gradients
    w.r.t. the origins are those through the staged query's twins."""
    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tff, "fused_density", counted("fused_density", tff.fused_density))
    monkeypatch.setattr(tff, "fused_field", counted("fused_field", tff.fused_field))
    pm, rays = _model(), _rays(40, seed=7)
    query = tmq.make_mega_radiance_query(pm, device="cpu")
    o = rays.origins.clone().requires_grad_()
    out = query(pm, rays.replace(origins=o), camera_index=1)
    assert not calls  # the forward is the kernel query's (its twin on the CPU)
    g = torch.autograd.grad(out.sum(), o)[0]
    assert calls == {"fused_density": 2}
    staged = tff.make_fused_radiance_query(pm, device="cpu")
    o2 = rays.origins.clone().requires_grad_()
    g2 = torch.autograd.grad(staged(pm, rays.replace(origins=o2), camera_index=1).sum(), o2)[0]
    assert calls == {"fused_density": 4, "fused_field": 1}
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    torch.testing.assert_close(g, g2)


def test_staged_recompute_is_the_staged_answer():
    """On the CPU, where K2's wrapper runs its twin, the staged query's
    `recompute` (the field through `_plain_field` directly) gives the same
    answer bit for bit."""
    pm, rays = _model(), _rays(24, seed=8)
    staged = tff.make_fused_radiance_query(pm, disable_box=BOX, device="cpu")
    with torch.no_grad():
        assert torch.equal(staged(pm, rays, camera_index=1), staged.recompute(pm, rays, camera_index=1))


@pytest.mark.parametrize("rows,per_sm,grid", [(3145728, 1, 132), (16777216, 2, 264), (1003 * 48, 1, 132),
                                              (1003, 2, 8)],
                         ids=["k2_field_rows", "k1_level0_rows", "k2_part_filled", "k1_small"])
def test_launch_shape_helpers(rows, per_sm, grid):
    """Passes are ceil(M / 128) (24,576 at the field's 3,145,728 rows); the
    persistent grid is min(passes, resident blocks)."""
    assert kernels.row_passes(rows) == -(-rows // 128)
    assert kernels.persistent_grid(rows, per_sm, 132) == grid == min(kernels.row_passes(rows), per_sm * 132)
    if rows == 3145728:
        assert kernels.row_passes(rows) == 24576


def test_shared_memory_of_k1_and_k2_fits():
    """K1: alignment slack 1,024, the pack padded to 18,432, two 8 KB slabs,
    128 keep flags, the mbarrier: 36,368 bytes, so shared memory allows
    six blocks per SM (registers allow two). K2: the field stage with its
    two slabs, 165,952 bytes, one block per SM."""
    assert kernels.density_smem_bytes() == 36368 and 6 * kernels.density_smem_bytes() <= 232448
    assert kernels.field_smem_bytes() == 165952 <= kernels.SMEM_LIMIT


def test_permute_first_index_is_made_once_per_device():
    """permute_first gives W[p] for the f-major permutation p; its index
    tensor is made once (a host list copied on every call would
    synchronise the stream ahead of each launch)."""
    ws, _ = _proposal(6)
    got = tff.permute_first(ws, 6)
    assert torch.equal(got[0], ws[0][tff.fmajor_permutation(6)]) and got[1] is ws[1]
    assert tff._fmajor_index(6, CPU) is tff._fmajor_index(6, CPU)
