"""The kernel emitter query (port of nerf_emitter_tpu/ops/mega_query.py):
its forward is K5 (`mega_pipeline`); K3 (`proposal_bins`) places the
bins of its frozen backward, and K4 (`field_composite`), K4 on K3's bins,
is the two-kernel form of K5's answer. P2 (`proposal_variant`) is K3 with
pieces stubbed out for profiling.

  K3 (proposals): uniform spacing bins -> level-0 density MLP -> weights ->
    inverse-CDF resample -> level-1 density MLP -> weights -> resample ->
    final spacing bins (s2+1, N). csrc/proposal.cu.
  K4 (field): bins -> positions -> base MLP + SH / appearance head ->
    weights -> composite with the last-sample background -> rgb (3, N).
    csrc/field_composite.cu; its MLP is the wgmma field of
    csrc/field_mlp.cuh, which `field_mlp` runs alone on given rows.
  K5: K3 then K4 per ray group in one launch; the bins stay in shared
    memory, and the answer is K4's on K3's bins, bit for bit.
    csrc/mega_pipeline.cu.
  The vjp (`field_composite_vjp`): K4 transposed, the query's backward
    for a frozen NeRF: bins, rays and the gradient at the answer -> the
    gradients of o, d, near and far. csrc/field_composite_vjp.cu.

The rays' o, d, near, far are the only per-ray inputs; between K3 and K4
only the (s2+1, N) spacing bins cross device memory. The rows that fill a
ray batch (K5's 128-ray tiles, the recompute's chunks, the ranks' shards)
take the values of `RAY_PADS`. Sampling is the staged query's
deterministic serving mode (bin centres, no jitter).

The inverse CDF: the TPU kernel evaluates it as a telescoped sum of ReLU
ramps (exact up to ~1e-4 of the spacing range from cancellation); the port
finds each u's CDF segment (a binary search in the kernels, one warp a
ray) and interpolates within it, which is the same piecewise-linear
function without that cancellation.

Each kernel has a plain PyTorch twin (`_plain_proposal`,
`_plain_field_composite`, `_plain_mega_pipeline`, `_plain_proposal`'s
modes for P2, `_plain_field_mlp`, `_plain_field_composite_vjp`)
that the wrappers use for CPU tensors only.

The query's backward takes one of two routes, by what autograd asks of it.
When no NeRF parameter needs a gradient (the takeover's frozen emitter) it
is two launches: K3 places the bins K5's forward used, and the vjp kernel
differentiates the field and the composite on them; the bins are
constants (the resample stops the gradient at the weights). Otherwise,
for the weight gradients, it recomputes through the staged query
(ops/fused_field.py): K1 places the samples, whose own backward recomputes
through its twin, and the field stage runs its twin directly. A query of
more than RECOMPUTE_RAYS rays recomputes in chunks of exactly that many
(the last padded), so that a ray's gradient does not depend on the batch
it was asked in: a bin's last ulp moves the answer by ~0.1% at far = 4,
and the recompute's reductions and matrix products round differently as
their shapes change (past 2^31 elements, at 2^17 rays, the answer moved by
1.9e-3 and the gradient by up to 30% against the same rays asked in
halves). The vjp kernel works ray by ray, so it needs no chunks.

The same chunks serve the emitter query of a field that no kernel serves
(`pipelines/nerf_emitter.py`: the `hash` field, and any field on the
CPU): `chunked_forward` answers each chunk without a graph, and
`recompute_grads`, the loop of the recompute above, differentiates each
chunk again with one.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..parallel.mesh import fill_rows
from ..utils import profiler
from .fused_field import (
    _QueryConfig,
    _contract_and_select,
    _density_of,
    _freq_rows_fmajor,
    _freqs_of,
    _kernel_mlp,
    _mlp_params,
    _rgb_of,
    _sh4_rows,
    make_fused_radiance_query,
    named_params,
    permute_first,
)
from .samplers import spacing_piecewise as _spacing_pw
from .samplers import spacing_piecewise_inv as _spacing_pw_inv

TILE_RAYS = 128  # the query pads the ray count to whole 128-ray tiles
RECOMPUTE_RAYS = 1 << 16  # rays a backward recomputes at once (_MegaQuery)
# the reference's pad values for the rows that fill a ray batch, one for
# each field of RayBundle; None: the last row repeated
RAY_PADS = {"origins": 0.0, "directions": 1.0, "pixel_area": 1e-4, "nears": 0.1, "fars": 0.2,
            "camera_indices": 0, "valid": None}
_EPS = 1e-5  # sample_pdf eps
_HIST_PAD = 0.01  # sample_pdf histogram_padding


def _weights_rows(dens: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """(S, R) volume-rendering weights alpha * exp(-exclusive cumsum)."""
    dd = dens * deltas
    excl = torch.cumsum(torch.cat([torch.zeros_like(dd[:1]), dd[:-1]], dim=0), dim=0)
    return (1.0 - torch.exp(-dd)) * torch.exp(-excl)


def _resample_rows(weights: torch.Tensor, sbins: torch.Tensor, n_out: int) -> torch.Tensor:
    """Deterministic inverse-CDF resample (sample_pdf, key=None): (S, R)
    weights and (S+1, R) spacing bins -> (n_out+1, R) spacing bins."""
    s_in, r = weights.shape
    w = weights + _HIST_PAD
    w_sum = w.sum(dim=0, keepdim=True)
    padding = (_EPS - w_sum).clamp(min=0.0)
    pdf = (w + padding / s_in) / (w_sum + padding)
    incl = torch.cumsum(pdf, dim=0)
    cdf = torch.cat([torch.zeros_like(incl[:1]), incl[:-1].clamp(max=1.0), torch.ones_like(incl[:1])])
    step = (1.0 - _EPS) / n_out
    u = torch.tensor([i * step + 1.0 / (2.0 * (n_out + 1)) for i in range(n_out + 1)],
                     dtype=torch.float32, device=weights.device)
    cdf_r, sb_r = cdf.T.contiguous(), sbins.T.contiguous()  # (R, S+1)
    u_r = u.expand(r, n_out + 1).contiguous()
    b = torch.searchsorted(cdf_r[:, 1:s_in].contiguous(), u_r, right=True)  # segment in [0, S-1]
    c0, c1 = cdf_r.gather(1, b), cdf_r.gather(1, b + 1)
    sb0, sb1 = sb_r.gather(1, b), sb_r.gather(1, b + 1)
    frac = ((u_r - c0) / (c1 - c0).clamp(min=_EPS)).clamp(0.0, 1.0)
    return (sb0 + (sb1 - sb0) * frac).T


def _density_rows(ebins, o, d, ws, bs, *, num_freqs, aabb_lo, aabb_inv_ext, disable_box, avg_density):
    """(S+1, R) euclidean bins -> (S, R) densities at the midpoints."""
    s, r = ebins.shape[0] - 1, ebins.shape[1]
    mid = (ebins[:-1] + ebins[1:]) / 2.0
    pos = (o[:, None, :] + d[:, None, :] * mid[None]).reshape(3, s * r)
    x2, keep = _contract_and_select(pos, aabb_lo, aabb_inv_ext, disable_box)
    raw = _kernel_mlp(_freq_rows_fmajor(x2, num_freqs).T, ws, bs)
    return _density_of(raw[:, 0], keep, avg_density).reshape(s, r)


# ---------------------------------------------------------------------------
# K3: both proposal levels -> final spacing bins
# ---------------------------------------------------------------------------


PROPOSAL_MODES = ("full", "dens-only", "resample-only")  # csrc/emitter_query.cuh ProposalMode


def _plain_proposal(o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, *, s0, s1, s2, freqs0, freqs1,
                    aabb_lo, aabb_inv_ext, disable_box, avg_density, mode="full"):
    """Twin of the proposal kernel: rays (3, N) / (1, N) -> (s2+1, N) bins.
    First-layer weight rows are in f-major order (`permute_first`). `mode`
    stubs pieces out as P2 does: "dens-only" replaces each resample by
    uniform bins i/s, "resample-only" each density by 0.3 x the sample's
    far bin edge."""
    r = o_t.shape[1]
    s_near, s_far = _spacing_pw(near_t), _spacing_pw(far_t)
    kw = dict(aabb_lo=aabb_lo, aabb_inv_ext=aabb_inv_ext, disable_box=disable_box,
              avg_density=avg_density)
    sbins = (torch.arange(s0 + 1, device=o_t.device, dtype=torch.float32) / float(s0))[:, None]
    sbins = sbins.expand(s0 + 1, r)
    for ws, bs, freqs, n_out in ((ws0, bs0, freqs0, s1), (ws1, bs1, freqs1, s2)):
        ebins = _spacing_pw_inv(sbins * (s_far - s_near) + s_near)
        if mode == "resample-only":
            dens = ebins[1:] * 0.3
        else:
            dens = _density_rows(ebins, o_t, d_t, ws, bs, num_freqs=freqs, **kw)
        wts = _weights_rows(dens, ebins[1:] - ebins[:-1])
        if mode == "dens-only":
            sbins = (torch.arange(n_out + 1, device=o_t.device, dtype=torch.float32)
                     / float(n_out))[:, None].expand(n_out + 1, r)
        else:
            sbins = _resample_rows(wts, sbins, n_out)
    return sbins


def _check_rays(o_t, d_t, near_t, far_t):
    n = o_t.shape[1]
    for name, t, rows in (("o_t", o_t, 3), ("d_t", d_t, 3), ("near_t", near_t, 1), ("far_t", far_t, 1)):
        kernels.check_tensor(t, name, ndim=2, rows=rows, cols=n)


def _launch_proposal(name, mode_args, count_as, o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, *, s0,
                     s1, s2, freqs0, freqs1, aabb_lo, aabb_inv_ext, disable_box, avg_density):
    n = o_t.shape[1]
    _check_rays(o_t, d_t, near_t, far_t)
    packs = _proposal_packs(ws0, bs0, ws1, bs1, o_t.device)
    out = torch.empty(s2 + 1, n, dtype=torch.float32, device=o_t.device)
    kernels.launch(
        name, *mode_args,
        kernels.ptr(o_t), kernels.ptr(d_t), kernels.ptr(near_t), kernels.ptr(far_t), kernels.i64(n),
        *[kernels.ptr(pk.buffer) for pk in packs],
        kernels.box_consts(aabb_lo, aabb_inv_ext, disable_box, avg_density),
        kernels.i32(freqs0), kernels.i32(freqs1), kernels.i32(s0), kernels.i32(s1), kernels.i32(s2),
        kernels.ptr(out), count_as=count_as,
    )
    return out


def _proposal_packs(ws0, bs0, ws1, bs1, device):
    """Both proposal MLPs (f-major first-layer rows) packed for the density
    block of K3's and K5's proposal stage (`kernels.DensityPack`)."""
    return kernels.DensityPack(ws0, bs0, device=device), kernels.DensityPack(ws1, bs1, device=device)


def proposal_bins(o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, *, s0, s1, s2, freqs0, freqs1,
                  aabb_lo, aabb_inv_ext, disable_box, avg_density):
    """Kernel K3: o_t, d_t (3, N), near_t, far_t (1, N) -> spacing bins
    (s2+1, N). Weights are (in, out) with f-major first-layer rows. The
    twin serves CPU tensors; a CUDA tensor launches the kernel."""
    kw = dict(s0=s0, s1=s1, s2=s2, freqs0=freqs0, freqs1=freqs1, aabb_lo=aabb_lo,
              aabb_inv_ext=aabb_inv_ext, disable_box=disable_box, avg_density=avg_density)
    if o_t.device.type == "cpu":
        return _plain_proposal(o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, **kw)
    return _launch_proposal("proposal", (), None, o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, **kw)


def proposal_variant(o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, *, mode, s0, s1, s2, freqs0,
                     freqs1, aabb_lo, aabb_inv_ext, disable_box, avg_density):
    """Kernel P2: K3 with pieces stubbed out (`mode` in PROPOSAL_MODES, see
    `_plain_proposal`), the same inputs and output. "full" launches K3's
    own instantiation."""
    if mode not in PROPOSAL_MODES:
        raise ValueError(f"mode must be one of {PROPOSAL_MODES}, got {mode!r}")
    kw = dict(s0=s0, s1=s1, s2=s2, freqs0=freqs0, freqs1=freqs1, aabb_lo=aabb_lo,
              aabb_inv_ext=aabb_inv_ext, disable_box=disable_box, avg_density=avg_density)
    if o_t.device.type == "cpu":
        return _plain_proposal(o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, mode=mode, **kw)
    return _launch_proposal("proposal_variant", (kernels.i32(PROPOSAL_MODES.index(mode)),),
                            f"proposal_variant[{mode}]", o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1,
                            **kw)


# ---------------------------------------------------------------------------
# K4: field + compositing
# ---------------------------------------------------------------------------


def _plain_field_composite(sbins, o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs, *, s2, freqs,
                           aabb_lo, aabb_inv_ext, disable_box, avg_density, hdr, rgb_bias,
                           with_aux=False):
    """Twin of the field/composite kernel: (s2+1, N) bins -> rgb (3, N),
    and with `with_aux` also (acc, rgb_last) as (4, N)."""
    r = o_t.shape[1]
    s_near, s_far = _spacing_pw(near_t), _spacing_pw(far_t)
    ebins = _spacing_pw_inv(sbins * (s_far - s_near) + s_near)
    mid = (ebins[:-1] + ebins[1:]) / 2.0
    pos = (o_t[:, None, :] + d_t[:, None, :] * mid[None]).reshape(3, s2 * r)
    x2, keep = _contract_and_select(pos, aabb_lo, aabb_inv_ext, disable_box)
    base = _kernel_mlp(_freq_rows_fmajor(x2, freqs).T, bws, bbs)  # (s2 R, 16)
    dens = _density_of(base[:, 0], keep, avg_density).reshape(s2, r)
    dirs = d_t[:, None, :].expand(3, s2, r).reshape(3, s2 * r)
    h_in = torch.cat([_sh4_rows(dirs).T, base[:, 1:], emb[None, :].expand(s2 * r, -1)], dim=1)
    rgb = _rgb_of(_kernel_mlp(h_in, hws, hbs), hdr, rgb_bias).reshape(s2, r, 3)
    w = _weights_rows(dens, ebins[1:] - ebins[:-1])
    comp = torch.sum(w[..., None] * rgb, dim=0)  # (R, 3)
    acc = torch.sum(w, dim=0)
    out = (comp + rgb[-1] * (1.0 - acc)[:, None]).T
    return (out, torch.cat([acc[None], rgb[-1].T])) if with_aux else out


def _check_field(o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs):
    """Check the rays and the appearance vector for a field kernel (K4,
    K5); pack the field's MLPs for the wgmma field."""
    _check_rays(o_t, d_t, near_t, far_t)
    kernels.check_tensor(emb, "emb", ndim=1)
    return kernels.FieldPack(bws, bbs, hws, hbs, emb.shape[0], device=o_t.device)


def field_composite(sbins, o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs, *, s2, freqs,
                    aabb_lo, aabb_inv_ext, disable_box, avg_density, hdr, rgb_bias, with_aux=False):
    """Kernel K4: spacing bins (s2+1, N), rays (3, N) / (1, N), one
    appearance vector (E,) -> rgb (3, N). Weights are (in, out) with
    f-major first-layer rows in the base MLP. `with_aux` also returns each
    ray's accumulation and last-sample colour (4, N): rgb minus
    rgb_last (1 - acc) is the composite without its background term."""
    kw = dict(s2=s2, freqs=freqs, aabb_lo=aabb_lo, aabb_inv_ext=aabb_inv_ext,
              disable_box=disable_box, avg_density=avg_density, hdr=hdr, rgb_bias=rgb_bias,
              with_aux=with_aux)
    if o_t.device.type == "cpu":
        return _plain_field_composite(sbins, o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs, **kw)
    n = o_t.shape[1]
    kernels.check_tensor(sbins, "sbins", ndim=2, rows=s2 + 1, cols=n)
    field = _check_field(o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs)
    out = torch.empty(3, n, dtype=torch.float32, device=o_t.device)
    aux = torch.empty(4, n, dtype=torch.float32, device=o_t.device) if with_aux else None
    kernels.launch(
        "field_composite",
        kernels.ptr(sbins), kernels.ptr(o_t), kernels.ptr(d_t), kernels.ptr(near_t),
        kernels.ptr(far_t), kernels.ptr(emb), kernels.i32(emb.shape[0]), kernels.i64(n),
        *field.args(), kernels.box_consts(aabb_lo, aabb_inv_ext, disable_box, avg_density),
        kernels.i32(freqs), kernels.i32(s2), kernels.i32(int(hdr)), kernels.f32(rgb_bias),
        kernels.ptr(out), kernels.ptr(aux) if with_aux else None,
    )
    return (out, aux) if with_aux else out


# ---------------------------------------------------------------------------
# the vjp: K4 transposed, the backward for a frozen NeRF
# ---------------------------------------------------------------------------


def _plain_field_composite_vjp(sbins, o_t, d_t, near_t, far_t, g_t, emb, bws, bbs, hws, hbs, **kw):
    """Twin of the vjp kernel: autograd through `_plain_field_composite`
    at the given bins, a constant, with the field frozen: the gradients of
    o_t, d_t (3, N) and near_t, far_t (1, N) given g_t (3, N) at the
    answer."""
    rays = [t.detach().requires_grad_() for t in (o_t, d_t, near_t, far_t)]
    frozen = [[t.detach() for t in ts] for ts in (bws, bbs, hws, hbs)]
    with torch.enable_grad():
        out = _plain_field_composite(sbins.detach(), *rays, emb.detach(), *frozen, **kw)
    return torch.autograd.grad(out, rays, g_t)


def field_composite_vjp(sbins, o_t, d_t, near_t, far_t, g_t, emb, bws, bbs, hws, hbs, *, s2, freqs,
                        aabb_lo, aabb_inv_ext, disable_box, avg_density, hdr, rgb_bias):
    """The vjp kernel: spacing bins (s2+1, N), rays (3, N) / (1, N), the
    gradient g_t (3, N) reaching K4's answer on those bins, one appearance
    vector (E,) -> the gradients of o_t, d_t (3, N), near_t and far_t
    (1, N), the field's weights frozen (no gradient of theirs is made).
    Weights are (in, out) with f-major first-layer rows in the base MLP.
    The twin serves CPU tensors; a CUDA tensor launches the kernel."""
    kw = dict(s2=s2, freqs=freqs, aabb_lo=aabb_lo, aabb_inv_ext=aabb_inv_ext,
              disable_box=disable_box, avg_density=avg_density, hdr=hdr, rgb_bias=rgb_bias)
    if o_t.device.type == "cpu":
        return _plain_field_composite_vjp(sbins, o_t, d_t, near_t, far_t, g_t, emb, bws, bbs, hws, hbs, **kw)
    n = o_t.shape[1]
    kernels.check_tensor(sbins, "sbins", ndim=2, rows=s2 + 1, cols=n)
    kernels.check_tensor(g_t, "g_t", ndim=2, rows=3, cols=n)
    field = _check_field(o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs)
    # the base output's density column as the bf16 values the field uses
    w0 = bws[-1][:, 0].detach().to(torch.bfloat16).float().contiguous()
    outs = [torch.empty(rows, n, dtype=torch.float32, device=o_t.device) for rows in (3, 3, 1, 1)]
    kernels.launch(
        "field_composite_vjp",
        kernels.ptr(sbins), kernels.ptr(o_t), kernels.ptr(d_t), kernels.ptr(near_t), kernels.ptr(far_t),
        kernels.ptr(g_t), kernels.ptr(emb), kernels.i32(emb.shape[0]), kernels.i64(n), *field.args(),
        kernels.ptr(w0), kernels.box_consts(aabb_lo, aabb_inv_ext, disable_box, avg_density),
        kernels.i32(freqs), kernels.i32(s2), kernels.i32(int(hdr)), kernels.f32(rgb_bias),
        *[kernels.ptr(t) for t in outs],
    )
    return tuple(outs)


# ---------------------------------------------------------------------------
# K5: the whole query in one launch
# ---------------------------------------------------------------------------


def _plain_mega_pipeline(o_t, d_t, near_t, far_t, emb, ws0, bs0, ws1, bs1, bws, bbs, hws, hbs, *,
                         s0, s1, s2, freqs0, freqs1, freqs, aabb_lo, aabb_inv_ext, disable_box,
                         avg_density, hdr, rgb_bias, with_aux=False):
    """Twin of the pipelined kernel: the proposal twin, then the
    field/composite twin on its bins (what the TPU kernel computes per tile,
    mega_query.py:335)."""
    box = dict(aabb_lo=aabb_lo, aabb_inv_ext=aabb_inv_ext, disable_box=disable_box,
               avg_density=avg_density)
    sbins = _plain_proposal(o_t, d_t, near_t, far_t, ws0, bs0, ws1, bs1, s0=s0, s1=s1, s2=s2,
                            freqs0=freqs0, freqs1=freqs1, **box)
    return _plain_field_composite(sbins, o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs, s2=s2,
                                  freqs=freqs, hdr=hdr, rgb_bias=rgb_bias, with_aux=with_aux, **box)


def mega_pipeline(o_t, d_t, near_t, far_t, emb, ws0, bs0, ws1, bs1, bws, bbs, hws, hbs, *, s0, s1,
                  s2, freqs0, freqs1, freqs, aabb_lo, aabb_inv_ext, disable_box, avg_density, hdr,
                  rgb_bias, with_aux=False):
    """Kernel K5: rays o_t, d_t (3, N), near_t, far_t (1, N) and one
    appearance vector (E,) -> rgb (3, N), and with `with_aux` also (acc,
    rgb_last) as (4, N): K3's bins and K4's field and composite in one
    launch, equal to K4 on K3's bins."""
    kw = dict(s0=s0, s1=s1, s2=s2, freqs0=freqs0, freqs1=freqs1, freqs=freqs, aabb_lo=aabb_lo,
              aabb_inv_ext=aabb_inv_ext, disable_box=disable_box, avg_density=avg_density, hdr=hdr,
              rgb_bias=rgb_bias, with_aux=with_aux)
    if o_t.device.type == "cpu":
        return _plain_mega_pipeline(o_t, d_t, near_t, far_t, emb, ws0, bs0, ws1, bs1, bws, bbs, hws,
                                    hbs, **kw)
    n = o_t.shape[1]
    field = _check_field(o_t, d_t, near_t, far_t, emb, bws, bbs, hws, hbs)
    packs = _proposal_packs(ws0, bs0, ws1, bs1, o_t.device)
    out = torch.empty(3, n, dtype=torch.float32, device=o_t.device)
    aux = torch.empty(4, n, dtype=torch.float32, device=o_t.device) if with_aux else None
    kernels.launch(
        "mega_pipeline",
        kernels.ptr(o_t), kernels.ptr(d_t), kernels.ptr(near_t), kernels.ptr(far_t),
        kernels.ptr(emb), kernels.i32(emb.shape[0]), kernels.i64(n),
        *[kernels.ptr(pk.buffer) for pk in packs], *field.args(),
        kernels.box_consts(aabb_lo, aabb_inv_ext, disable_box, avg_density),
        kernels.i32(freqs0), kernels.i32(freqs1), kernels.i32(freqs), kernels.i32(s0),
        kernels.i32(s1), kernels.i32(s2), kernels.i32(int(hdr)), kernels.f32(rgb_bias), kernels.ptr(out),
        kernels.ptr(aux) if with_aux else None,
    )
    return (out, aux) if with_aux else out


def check_query_shapes(p: dict, s0: int, s1: int, s2: int) -> None:
    """Raise ValueError unless K3, K4, K5 and the vjp kernel take the model
    of named parameters `p` at these sample counts: the wgmma field takes
    its widths (`kernels.check_field_widths`), the vjp at most
    `kernels.VJP_MAX_SAMPLES` samples a ray, and the kernels' shared memory
    fits a block. (The proposal MLPs' widths are checked with the staged
    query's, `check_staged_shapes`.)"""
    shapes = {k: [w.shape for w in _mlp_params(p, k)[0]] for k in ("field.base_mlp", "field.head_mlp")}
    kernels.check_field_widths(shapes["field.base_mlp"], shapes["field.head_mlp"])
    if s2 > kernels.VJP_MAX_SAMPLES:
        raise ValueError(f"the vjp kernel takes at most {kernels.VJP_MAX_SAMPLES} samples a ray, got {s2}")
    words = kernels.field_mask_words(shapes["field.base_mlp"], shapes["field.head_mlp"])
    for name, need in (("K3", kernels.proposal_smem_bytes(s0, s1, s2)),
                       ("K4", kernels.field_composite_smem_bytes(s2)),
                       ("K5", kernels.mega_pipeline_smem_bytes(s0, s1, s2)),
                       ("the vjp kernel", kernels.field_composite_vjp_smem_bytes(s2, words))):
        if need > kernels.SMEM_LIMIT:
            raise ValueError(f"{name} needs {need} bytes of shared memory at samples "
                             f"({s0}, {s1}, {s2}), more than a block's {kernels.SMEM_LIMIT}")


# ---------------------------------------------------------------------------
# the field MLP alone (K4's and K5's field stage)
# ---------------------------------------------------------------------------


def _plain_field_mlp(x, sh, emb, bws, bbs, hws, hbs, *, depth=None):
    """Twin of the field MLP alone: x (m, k) base input rows, sh (m, 16)
    SH rows, emb (E,) -> the output of the first `depth` layers (the base
    MLP's, then the head's; all of them by default) with the kernels'
    arithmetic (`_kernel_mlp`): bf16 activations after a hidden layer (as
    f32), the f32 base output, or the head's raw f32 output (m, 3)."""
    bf = torch.bfloat16
    layers = list(zip((*bws, *hws), (*bbs, *hbs)))
    depth = len(layers) if depth is None else depth
    h = x[:, : bws[0].shape[0]].to(bf).float()
    for i, (w, b) in enumerate(layers[:depth]):
        if i == len(bws):  # the head's input: [SH, geo, emb]
            h = torch.cat([sh, h[:, 1:], emb[None, :].expand(h.shape[0], -1)], dim=1).to(bf).float()
        if i == len(layers) - 1:
            h = h @ w + b  # the f32 reduce keeps the weight in f32
        elif i == len(bws) - 1:
            h = h @ w.to(bf).float() + b
        else:
            h = torch.relu((h @ w.to(bf).float() + b).to(bf)).float()
    return h


def field_mlp(x, sh, emb, bws, bbs, hws, hbs, *, depth=None):
    """The wgmma field MLP of K4 and K5 alone (csrc/field_mlp.cu) on rows x
    (m, k) float32 (the base MLP's input; rounded to bf16 and zero-padded to
    the first layer's width), sh (m, 16) and emb (E,): the output of
    `_plain_field_mlp` at the same `depth`. The twin serves CPU tensors; a
    CUDA tensor launches the kernel."""
    n_layers = len(bws) + len(hws)
    depth = n_layers if depth is None else depth
    if not 1 <= depth <= n_layers:
        raise ValueError(f"depth must be in [1, {n_layers}], got {depth}")
    if x.device.type == "cpu":
        return _plain_field_mlp(x, sh, emb, bws, bbs, hws, hbs, depth=depth)
    m = x.shape[0]
    kernels.check_tensor(x, "x", ndim=2, rows=m)
    kernels.check_tensor(sh, "sh", ndim=2, rows=m, cols=16)
    kernels.check_tensor(emb, "emb", ndim=1)
    pack = kernels.FieldPack(bws, bbs, hws, hbs, emb.shape[0], device=x.device)
    xb = torch.zeros(m, pack.k0, dtype=torch.bfloat16, device=x.device)
    xb[:, : bws[0].shape[0]] = x[:, : bws[0].shape[0]]
    out = torch.empty(m, [w.shape[1] for w in (*bws, *hws)][depth - 1], dtype=torch.float32,
                      device=x.device)
    launch_field_mlp(pack, xb, sh, emb, depth, out)
    return out


def launch_field_mlp(pack, xb, sh, emb, depth, out=None):
    """One launch of the field MLP alone on packed weights (`kernels.FieldPack`)
    and bf16 rows xb (m, pack.k0); with out None nothing is written (how
    chip_smoke.py times each depth)."""
    kernels.launch(
        "field_mlp", kernels.ptr(xb), kernels.i32(pack.k0), kernels.ptr(sh), kernels.ptr(emb),
        kernels.i32(emb.shape[0]), kernels.i64(xb.shape[0]), *pack.args(), kernels.i32(depth),
        kernels.ptr(out) if out is not None else None,
    )


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


class _MegaQuery(torch.autograd.Function):
    """Forward through K5. The backward's route follows what
    autograd asks: with no NeRF parameter needing a gradient, `run.vjp`
    (K3's bins, then the vjp kernel); otherwise the recompute through the
    staged query (the reference's custom_vjp), with K1 placing the samples
    and the field stage through its twin (`run.staged` is the staged
    query's `recompute`): K2's output would go unread there, as the
    reference's `jax.vjp` drops the primal."""

    @staticmethod
    def forward(ctx, run, origins, directions, nears, fars, *params):
        ctx.run = run
        ctx.save_for_backward(origins, directions, nears, fars, *params)
        return run.forward(dict(zip(run.names, params)), origins, directions, nears, fars)

    @staticmethod
    @profiler.span("emitter.backward")
    def backward(ctx, g):
        need = ctx.needs_input_grad[1:]
        o, d, near, far, *params = ctx.saved_tensors
        run = ctx.run
        if any(need[4:]):
            inputs = ("origins", "directions", "nears", "fars")
            fields = {f.name: getattr(run.rays, f.name) for f in dataclasses.fields(run.rays)}
            fields.update(zip(inputs, (o, d, near, far)))
            leaves = [t.detach().requires_grad_(n) for t, n in zip(params, need[4:])]

            def staged(rows, ps):
                return run.staged(dict(zip(run.names, ps)), type(run.rays)(**rows), run.camera_index)

            ray_grads, param_grads = recompute_grads(staged, fields, dict(zip(inputs, need[:4])), leaves, g)
            return (None, *ray_grads, *param_grads)
        profiler.count("emitter.vjp_rays", o.shape[0])
        grads = run.vjp(dict(zip(run.names, params)), o, d, near, far, g)
        return (None, *[gi if nd else None for gi, nd in zip(grads, need[:4])], *[None] * len(params))


# ---------------------------------------------------------------------------
# the chunked recompute: the kernel query's backward with a NeRF parameter
# trained, and the emitter query of a field no kernel serves
# (pipelines/nerf_emitter.py)
# ---------------------------------------------------------------------------


def _chunks(fields: dict, n: int):
    """(start, stop, rows) for each chunk of the n rows of `fields` ({name:
    (n, ...) tensor or None}): RECOMPUTE_RAYS rows a chunk (n itself where n
    is no more), each field's rows start:stop padded to the chunk with its
    RAY_PADS value (a field of no RayBundle name: its last row repeated)."""
    chunk = n if n <= RECOMPUTE_RAYS else RECOMPUTE_RAYS
    for start in range(0, n, chunk) if n else [0]:
        stop = min(start + chunk, n)
        yield start, stop, {k: None if v is None else fill_rows(v[start:stop], chunk, RAY_PADS.get(k))
                            for k, v in fields.items()}


def chunked_forward(fn, fields: dict, n: int) -> tuple:
    """fn(rows) -> a tuple of (chunk, ...) tensors on each chunk of the n
    rows of `fields` (`_chunks`), without a graph; each tensor's n rows.
    Counts emitter.forward_chunks."""
    outs = []
    with torch.no_grad():
        for start, stop, rows in _chunks(fields, n):
            profiler.count("emitter.forward_chunks", 1)
            outs.append([t[:stop - start] for t in fn(rows)])
    return tuple(torch.cat(ts) for ts in zip(*outs))


def recompute_grads(fn, fields: dict, need: dict, params: list, g: torch.Tensor):
    """The gradients given g (n, ...) at the answer of fn(rows, params), by
    autograd through fn recomputed with a graph on each chunk of `fields`
    (`_chunks`), so that memory holds one chunk's graph: ([the gradient
    of each field named in `need`, in its order, or None where `need` says
    False], [each parameter's gradient summed over the chunks, or None
    where it requires none]). Counts emitter.recompute_chunks and
    emitter.recompute_rays (the chunks' rows, the padding included)."""
    n = g.shape[0]
    ray_grads = {k: [] for k in need}
    param_grads = [None] * len(params)
    for start, stop, rows in _chunks(fields, n):
        leaves = {k: rows[k].detach().requires_grad_(nd) for k, nd in need.items()}
        with torch.enable_grad():
            out = fn(dict(rows, **leaves), params)
        profiler.count("emitter.recompute_chunks", 1)
        profiler.count("emitter.recompute_rays", out.shape[0])
        wanted = [t for t in [*leaves.values(), *params] if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, fill_rows(g[start:stop], out.shape[0], 0.0), allow_unused=True))
        for k, t in leaves.items():
            if t.requires_grad:
                gi = next(got)
                ray_grads[k].append(torch.zeros_like(t[:stop - start]) if gi is None else gi[:stop - start])
        for i, t in enumerate(params):
            if t.requires_grad:
                gi = next(got)
                param_grads[i] = gi if param_grads[i] is None else (param_grads[i] if gi is None
                                                                     else param_grads[i] + gi)
    return [torch.cat(ray_grads[k]) if need[k] else None for k in need], param_grads


class _MegaRun:
    """One query call's state, handed to the autograd Function."""

    def __init__(self, forward, vjp, staged, names, rays, camera_index):
        self.forward, self.vjp, self.staged, self.names = forward, vjp, staged, names
        self.rays, self.camera_index = rays, camera_index


def make_mega_radiance_query(model, *, disable_box=None, device=None):
    """The kernel query, with the contract of `make_fused_radiance_query`:
    query(params_or_model, rays, camera_index=None) -> rgb (n, 3), one
    camera for all rays.

    The forward is one K5 launch on the rays padded to whole 128-ray tiles.
    The reference's two switches, the two-kernel forward and the MXU's
    column slices (NERF_EMITTER_MEGA_PIPELINED, NERF_EMITTER_MEGA_MXU_CHUNK),
    have no counterpart here: K5's answer is K4's on K3's bins, bit for
    bit, and its wgmma field has no column slices.

    A field whose widths the wgmma field does not take, or sample counts
    that the vjp kernel does not take or whose shared memory does not fit a
    block, raise ValueError here (`check_query_shapes`); so does a proposal
    MLP that K1, which the recompute route of the backward runs, does not
    take (the staged query's `check_staged_shapes`). `device=None` means
    CUDA."""
    cfg = _QueryConfig(model, disable_box, device)
    s0, s1 = cfg.n_prop
    s2 = cfg.n_nerf
    check_query_shapes(named_params(model), s0, s1, s2)
    staged = make_fused_radiance_query(model, disable_box=disable_box, device=device)
    kw = dict(aabb_lo=cfg.aabb_lo, aabb_inv_ext=cfg.aabb_inv_ext, disable_box=cfg.dbox,
              avg_density=1.0)

    def weights(p, camera_index, dev):
        """The kernels' weights: both proposal MLPs and the field with
        f-major first-layer rows, their octave counts, the appearance
        vector."""
        ws0, bs0 = _mlp_params(p, "proposal_0.mlp")
        ws1, bs1 = _mlp_params(p, "proposal_1.mlp")
        bws, bbs = _mlp_params(p, "field.base_mlp")
        hws, hbs = _mlp_params(p, "field.head_mlp")
        f0, f1, ff = _freqs_of(ws0[0]), _freqs_of(ws1[0]), _freqs_of(bws[0])
        props = (permute_first(ws0, f0), bs0, permute_first(ws1, f1), bs1)
        field = (permute_first(bws, ff), bbs, hws, hbs)
        emb = cfg.embedding(p, camera_index, dev).contiguous()
        return props, field, emb, dict(freqs0=f0, freqs1=f1), ff

    def padded_rows(origins, directions, nears, fars):
        """The rays in the kernels' (3, N) / (1, N) layout, padded to whole
        128-ray tiles with RAY_PADS."""
        n_pad = -(-origins.shape[0] // TILE_RAYS) * TILE_RAYS
        return tuple(fill_rows(x, n_pad, RAY_PADS[k]).T.contiguous() for k, x in
                     (("origins", origins), ("directions", directions), ("nears", nears), ("fars", fars)))

    def make_forward(camera_index):
        def forward(p, origins, directions, nears, fars):
            rows = padded_rows(origins, directions, nears, fars)
            props, field, emb, fp, ff = weights(p, camera_index, origins.device)
            rgb_t = mega_pipeline(*rows, emb, *props, *field, s0=s0, s1=s1, s2=s2, **fp, freqs=ff, hdr=cfg.hdr,
                                  rgb_bias=cfg.rgb_bias, **kw)
            return rgb_t[:, :origins.shape[0]].T.contiguous()
        return forward

    def make_vjp(camera_index):
        def vjp(p, origins, directions, nears, fars, g):
            """The gradients of origins, directions, nears and fars given g
            (n, 3) at the answer, the NeRF frozen: K3 places the bins (K5's
            own), the vjp kernel differentiates the field and the
            composite on them."""
            rows = padded_rows(origins, directions, nears, fars)
            props, field, emb, fp, ff = weights(p, camera_index, origins.device)
            sbins = proposal_bins(*rows, *props, s0=s0, s1=s1, s2=s2, **fp, **kw)
            g_t = fill_rows(g, rows[0].shape[1], 0.0).T.contiguous()
            grads = field_composite_vjp(sbins, *rows, g_t, emb, *field, s2=s2, freqs=ff, hdr=cfg.hdr,
                                        rgb_bias=cfg.rgb_bias, **kw)
            return [t[:, :origins.shape[0]].T for t in grads]
        return vjp

    def query(params_or_model, rays, camera_index=None):
        p = named_params(params_or_model)
        names = [k for k in p if k.startswith(("proposal_0.", "proposal_1.", "field."))]
        run = _MegaRun(make_forward(camera_index), make_vjp(camera_index), staged.recompute, names, rays,
                       camera_index)
        return _MegaQuery.apply(run, rays.origins, rays.directions, rays.nears, rays.fars,
                                *[p[k] for k in names])

    return query
