"""The wgmma field MLP of K4 and K5 (csrc/field_mlp.cuh), on the CPU: its
weight packing against the (in, out) weights through a plain index map,
the width and shared-memory checks the query builder runs, the constants
the wrappers pad to, and the MLP-alone twin against the JAX package's
`_mlp_rowsT`, the MLP arithmetic of the TPU kernels. The kernels
themselves run on the card only (chip_smoke.py holds them against these
twins)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.ops import fused_field as jff
from nerf_emitter_tpu_torch import kernels
from nerf_emitter_tpu_torch.fields.nerfacto_field import NerfactoField
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops import fused_field as tff
from nerf_emitter_tpu_torch.ops import mega_query as tmq

torch.set_num_threads(1)

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
CFG = dict(num_nerf_samples=48, num_proposal_samples=(256, 96), num_cameras=4, appearance_embedding_dim=32,
           implementation="freq", device="cpu")
SDF_NERFACTO_BASE = [(63, 256), (256, 256), (256, 256), (256, 256), (256, 256), (256, 16)]
SDF_NERFACTO_HEAD = [(63, 64), (64, 64), (64, 3)]


@functools.lru_cache(maxsize=1)
def _model():
    """The main path's model (sdf-nerfacto widths, samples 256/96/48) on the
    CPU, random weights from a seed."""
    torch.manual_seed(0)
    return NerfactoModel(AABB, **CFG)


def _field_params(model):
    p = tff.named_params(model)
    bws, bbs = tff._mlp_params(p, "field.base_mlp")
    hws, hbs = tff._mlp_params(p, "field.head_mlp")
    return p, [w.detach() for w in bws], [b.detach() for b in bbs], [w.detach() for w in hws], \
        [b.detach() for b in hbs]


def _bf16_bits(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("k,n", [(63, 256), (256, 256), (256, 16), (63, 64), (64, 64), (256, 128),
                                 (128, 64), (100, 256)],
                         ids=["base_first_pad63", "base_hidden", "base_out", "head_first_pad63",
                              "head_hidden", "n128", "k128", "pad100"])
def test_wgmma_packing_matches_the_index_map(k, n):
    """pack_wgmma_layer puts W[kk, j] (bf16) at byte (kk // 64) * n * 128 +
    j * 128 + (((kk % 64) // 8) ^ (j % 8)) * 16 + (kk % 8) * 2, zero for the
    padded rows kk >= k, and fills the stream exactly."""
    w = torch.from_numpy(np.random.default_rng(k * 1000 + n).normal(size=(k, n)).astype(np.float32))
    got = _bf16_bits(kernels.pack_wgmma_layer(w))
    kp = -(-k // 64) * 64
    assert got.size == kp * n
    kk, j = np.meshgrid(np.arange(kp), np.arange(n), indexing="ij")
    byte = (kk // 64) * n * 128 + j * 128 + (((kk % 64) // 8) ^ (j % 8)) * 16 + (kk % 8) * 2
    idx = byte // 2
    assert np.unique(idx).size == kp * n
    want = np.zeros((kp, n), np.int16)
    want[:k] = _bf16_bits(w)
    np.testing.assert_array_equal(got[idx], want)


def test_field_pack_streams_the_sdf_nerfacto_field():
    """The sdf-nerfacto field packs into 8 wgmma layers and 20 chunks per
    pass, each at most one ring stage, back to back in one 581,632-byte
    stream; the launcher's dims carry (k, n, K blocks per chunk) per layer,
    then the head's f32 output layer and the stream's bytes."""
    _, bws, bbs, hws, hbs = _field_params(_model())
    pack = kernels.FieldPack(bws, bbs, hws, hbs, 32, device=torch.device("cpu"))
    assert pack.layers == [(64, 256, 1)] + [(256, 256, 1)] * 4 + [(256, 16, 4), (64, 64, 1), (64, 64, 1)]
    assert len(pack.chunks) == 20 <= kernels.FIELD_MAX_CHUNKS
    offsets = [0]
    for off, size in pack.chunks:
        assert off == offsets[-1] and 0 < size <= kernels.STAGE_BYTES and off % 1024 == 0
        offsets.append(off + size)
    assert offsets[-1] == 2 * pack.stream.numel() == 581632
    np.testing.assert_array_equal(_bf16_bits(pack.stream[: 64 * 256]),
                                  _bf16_bits(kernels.pack_wgmma_layer(bws[0])))
    dims = list(pack.args()[0])
    assert dims[:2] == [6, 2] and dims[-3:] == [64, 3, 581632]
    assert torch.equal(pack.w_last, hws[-1]) and pack.k0 == 64


def test_check_field_widths_accepts_the_sdf_nerfacto_field():
    """The main path's field passes the check, from the model's own
    parameters, and the query builds."""
    kernels.check_field_widths(SDF_NERFACTO_BASE, SDF_NERFACTO_HEAD, 32)
    p, bws, _, hws, _ = _field_params(_model())
    kernels.check_field_widths([w.shape for w in bws], [w.shape for w in hws], 32)
    tmq.check_query_shapes(p, 256, 96, 48)
    assert callable(tmq.make_mega_radiance_query(_model(), device="cpu"))


@pytest.mark.parametrize("base,head,n_emb,match", [
    ([(63, 96), (96, 16)], SDF_NERFACTO_HEAD, 32, "hidden widths"),
    ([(63, 512), (512, 16)], SDF_NERFACTO_HEAD, 32, "hidden widths"),
    ([(63, 256), (256, 8)], SDF_NERFACTO_HEAD, 32, "end 16 wide"),
    ([(63, 16)], SDF_NERFACTO_HEAD, 32, "hidden layer"),
    (SDF_NERFACTO_BASE, [(63, 32), (32, 3)], 32, "hidden widths"),
    (SDF_NERFACTO_BASE, [(63, 64), (64, 4)], 32, "end 3 wide"),
    ([(300, 256), (256, 16)], SDF_NERFACTO_HEAD, 32, "pad to at most"),
    (SDF_NERFACTO_BASE, SDF_NERFACTO_HEAD, 16, "appearance"),
    ([(63, 256), (128, 16)], SDF_NERFACTO_HEAD, 32, "after a 256-wide layer"),
], ids=["hidden96", "hidden512", "base_out8", "no_hidden", "head_hidden32", "head_out4",
        "input300", "emb_mismatch", "chain_break"])
def test_check_field_widths_raises_on_what_it_cannot_take(base, head, n_emb, match):
    with pytest.raises(ValueError, match=match):
        kernels.check_field_widths(base, head, n_emb)


def test_query_build_raises_on_an_unsupported_field_width():
    """A field 96 wide is refused when the query is built, not quietly run
    on another path."""
    torch.manual_seed(0)
    model = NerfactoModel(AABB, **CFG)
    model.field = NerfactoField(AABB, num_cameras=4, appearance_embedding_dim=32, implementation="freq",
                                freq_hidden_dim=96, device="cpu")
    with pytest.raises(ValueError, match="hidden widths"):
        tmq.make_mega_radiance_query(model, device="cpu")


def test_shared_memory_fits_at_the_main_path_shapes():
    """K4 and K5 at samples (256, 96, 48) and the sdf-nerfacto widths fit a
    block's 232,448 bytes: K4 173,856, K5 228,816 (the ring 98,304, the
    field slabs 65,536, where the proposal stage's two packs, 36,864 bytes,
    sit between field stages, the density block's work area 16,912, the
    proposal state 41,344, the colours 4,608)."""
    k4, k5 = kernels.field_composite_smem_bytes(48), kernels.mega_pipeline_smem_bytes(256, 96, 48)
    assert (k4, k5) == (173856, 228816)
    assert max(k4, k5) <= kernels.SMEM_LIMIT == 232448
    assert 2 * kernels.DENSITY_PACK_SPAN == 36864 <= 2 * kernels.SLAB_BYTES
    assert k5 == kernels.field_smem_bytes() + kernels.DENSITY_WORK + kernels.proposal_state_bytes(256, 96, 48) + 4608


def test_query_build_raises_when_shared_memory_does_not_fit():
    """2000 level-0 samples would need more than a block's shared memory in
    K5: the builder raises."""
    model = NerfactoModel(AABB, **(CFG | dict(num_proposal_samples=(2000, 96))))
    with pytest.raises(ValueError, match="shared memory"):
        tmq.make_mega_radiance_query(model, device="cpu")


def test_mega_ld_and_the_ray_group_constants():
    """K5's proposal stage takes its MLPs as density packs (one 17,424-byte
    buffer each, the main path's F=4 and F=6 proposals alike), not as row
    strides; the query pads rays to 128-ray tiles, which split into whole
    8-ray groups, and an 8-ray group of 48 samples into whole 128-row
    passes of two 64-row warpgroups."""
    p = tff.named_params(_model())
    packs = [kernels.DensityPack(*tff._mlp_params(p, f"proposal_{i}.mlp"), device=torch.device("cpu"))
             for i in (0, 1)]
    assert [pk.buffer.numel() for pk in packs] == [kernels.DENSITY_PACK_BYTES] * 2 == [17424] * 2
    assert not hasattr(tmq, "mega_ld") and not hasattr(kernels, "PackedMlp")
    assert tmq.TILE_RAYS % kernels.FIELD_RAYS == 0
    assert kernels.PASS_ROWS == 2 * kernels.WG_ROWS
    assert kernels.FIELD_RAYS * 48 % kernels.PASS_ROWS == 0


def _rows(m, n_emb, seed):
    rng = np.random.default_rng(seed)
    x2 = rng.uniform(-1.0, 1.0, size=(3, m)).astype(np.float32)
    d = rng.normal(size=(3, m)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    enc = tff._freq_rows_fmajor(torch.from_numpy(x2), 10).T.contiguous()
    sh = tff._sh4_rows(torch.from_numpy(d)).T.contiguous()
    emb = torch.from_numpy(rng.normal(size=n_emb).astype(np.float32) * 0.2)
    return enc, sh, emb


@pytest.mark.parametrize("stage", ["base", "head"])
def test_field_mlp_twin_matches_jax_mlp_rowsT(stage):
    """The MLP-alone twin against the JAX package's `_mlp_rowsT` on the same
    weights and rows: the base output after the base MLP, the head's raw
    output after the whole MLP (K2's twin-vs-Pallas bar)."""
    _, bws, bbs, hws, hbs = _field_params(_model())
    bws = tff.permute_first(bws, 10)
    enc, sh, emb = _rows(300, 32, seed=5)
    jb = np.asarray(jff._mlp_rowsT(jnp.asarray(enc.numpy().T), [jnp.asarray(w.numpy()) for w in bws],
                                   [jnp.asarray(b.numpy()) for b in bbs])).T
    if stage == "base":
        got = tmq.field_mlp(enc, sh, emb, bws, bbs, hws, hbs, depth=len(bws))
        np.testing.assert_allclose(got.numpy(), jb, rtol=2e-3, atol=1e-5)
        return
    hin = np.concatenate([sh.numpy(), jb[:, 1:], np.broadcast_to(emb.numpy(), (300, 32))], axis=1)
    jh = np.asarray(jff._mlp_rowsT(jnp.asarray(hin.T), [jnp.asarray(w.numpy()) for w in hws],
                                   [jnp.asarray(b.numpy()) for b in hbs])).T
    got = tmq.field_mlp(enc, sh, emb, bws, bbs, hws, hbs)
    np.testing.assert_allclose(got.numpy(), jh, rtol=2e-3, atol=1e-5)


def test_field_mlp_twin_is_the_field_twins_mlp():
    """At every depth the twin is the field/composite twin's chain
    (`_kernel_mlp` on the base, then on [SH, geo, emb]), bit for bit."""
    _, bws, bbs, hws, hbs = _field_params(_model())
    enc, sh, emb = _rows(64, 32, seed=6)
    base = tff._kernel_mlp(enc, bws, bbs)
    head = tff._kernel_mlp(torch.cat([sh, base[:, 1:], emb[None].expand(64, -1)], dim=1), hws, hbs)
    assert torch.equal(tmq.field_mlp(enc, sh, emb, bws, bbs, hws, hbs, depth=len(bws)), base)
    assert torch.equal(tmq.field_mlp(enc, sh, emb, bws, bbs, hws, hbs), head)
    first = torch.relu((enc.to(torch.bfloat16).float() @ bws[0].to(torch.bfloat16).float()
                        + bbs[0]).to(torch.bfloat16)).float()
    assert torch.equal(tmq.field_mlp(enc, sh, emb, bws, bbs, hws, hbs, depth=1), first)


def test_field_mlp_wrapper_goes_to_the_kernel_off_the_cpu():
    """A tensor that is not on the CPU goes to the kernel, never to the
    twin: on a device that has no kernel the wrapper raises; a depth out of
    range raises first."""
    _, bws, bbs, hws, hbs = _field_params(_model())
    meta = torch.device("meta")
    x, sh, emb = torch.empty(10, 63, device=meta), torch.empty(10, 16, device=meta), torch.empty(32, device=meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tmq.field_mlp(x, sh, emb, bws, bbs, hws, hbs)
    with pytest.raises(ValueError, match="depth"):
        tmq.field_mlp(x, sh, emb, bws, bbs, hws, hbs, depth=10)
