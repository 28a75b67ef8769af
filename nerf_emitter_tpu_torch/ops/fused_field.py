"""The fused field kernels K1 (`fused_density`) and K2 (`fused_field`) and
the staged emitter query (port of nerf_emitter_tpu/ops/fused_field.py).

Each kernel keeps the whole per-sample pipeline on chip: affine AABB map,
keep mask and carve-out box, frequency encoding by the double-angle
recurrence, every MLP layer, the output activation. Only positions and
directions are read and only densities and colours are written. The CUDA
sources are csrc/fused_density.cu (on the wgmma density block of
csrc/density_mlp.cuh) and csrc/fused_field.cu (on the wgmma field of
csrc/field_mlp.cuh). Both encode f-major; the wrappers permute the
first-layer rows to match (`permute_first`), and the twins stay k-major.

Public functions keep the JAX package's layouts: positions and directions
are (3, M) and MLP weights are (in, out) float32, as in the flax tree.

Beside each kernel sits its plain PyTorch twin (`_plain_density`,
`_plain_field`). The wrappers use the twin only for tensors on the CPU; for
CUDA tensors they launch the kernel or raise. Gradients recompute through
the twin (the reference's custom_vjp), so the kernel serves every forward.

MLP arithmetic of kernels and twins (the TPU kernels' `_mlp_rowsT`): bf16
operands, f32 accumulation, f32 bias, ReLU, re-cast to bf16; an output
layer at most 4 wide is an f32 reduce with the f32 weight.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn

from .. import kernels
from ..fields.encodings import sh_components
from ..utils.device import resolve_device
from ..utils.math import SAFE_EXP_MAX
from .samplers import sample_pdf, spaced_sample

_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# building blocks shared by the twins, on (features, T) rows
# ---------------------------------------------------------------------------


def _freq_rows(x2: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """x2 (3, T) in [-1, 1] -> (3 + 6F, T) rows in nerf_encode order
    ([x, sin (dim-major, octave-minor), cos]). Octaves come from the
    double-angle recurrence off one base sin/cos per dim (~3e-3 relative
    roundoff at F=10, below the bf16 rounding the MLP applies)."""
    ss, cs = _octaves(x2, num_freqs)
    sin_rows = [ss[i][k] for k in range(3) for i in range(num_freqs)]
    cos_rows = [cs[i][k] for k in range(3) for i in range(num_freqs)]
    return torch.cat([x2, torch.stack(sin_rows), torch.stack(cos_rows)], dim=0)


def _freq_rows_fmajor(x2: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Like _freq_rows with rows [x, sin octave-major (dim-minor), cos
    octave-major]; first-layer weight rows are permuted to match with
    `fmajor_permutation`."""
    ss, cs = _octaves(x2, num_freqs)
    return torch.cat([x2] + ss + cs, dim=0)


def _octaves(x2: torch.Tensor, num_freqs: int):
    theta = x2 * _TWO_PI
    s, c = torch.sin(theta), torch.cos(theta)
    ss, cs = [s], [c]
    for _ in range(num_freqs - 1):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        ss.append(s)
        cs.append(c)
    return ss, cs


def fmajor_permutation(num_freqs: int) -> list[int]:
    """Row permutation p with enc_fmajor[j] == enc_kmajor[p[j]]: apply as
    W_fmajor = W_kmajor[p] on the first-layer (in, out) weights."""
    f = num_freqs
    perm = list(range(3))
    perm += [3 + k * f + i for i in range(f) for k in range(3)]
    perm += [3 + 3 * f + k * f + i for i in range(f) for k in range(3)]
    return perm


def _sh4_rows(d: torch.Tensor) -> torch.Tensor:
    """Degree-4 real SH basis as rows: unit dirs (3, T) -> (16, T)."""
    return torch.stack(sh_components(d[0], d[1], d[2], 4), dim=0)


def _contract_and_select(pos: torch.Tensor, aabb_lo, aabb_inv_ext, disable_box):
    """pos (3, T) world -> (x2 (3, T) in [-1, 1] inside the box, keep (T,)).
    The affine map is the fake contraction; keep drops samples outside the
    scene box and strictly inside the carve-out box."""
    units = [(pos[k] - aabb_lo[k]) * aabb_inv_ext[k] for k in range(3)]
    keep = (
        (units[0] >= 0.0) & (units[0] <= 1.0)
        & (units[1] >= 0.0) & (units[1] <= 1.0)
        & (units[2] >= 0.0) & (units[2] <= 1.0)
    )
    if disable_box is not None:
        lo, hi = disable_box
        inside = (
            (pos[0] > lo[0]) & (pos[0] < hi[0])
            & (pos[1] > lo[1]) & (pos[1] < hi[1])
            & (pos[2] > lo[2]) & (pos[2] < hi[2])
        )
        keep = keep & ~inside
    return torch.stack(units, dim=0) * 2.0 - 1.0, keep


def _kernel_mlp(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor]) -> torch.Tensor:
    """(T, K) -> (T, out) with the kernels' arithmetic. ws are (in, out).
    bf16 products are taken as f32 products of bf16-rounded operands (a
    bf16 matmul would round its output)."""
    bf = torch.bfloat16
    h = x.to(bf).float()
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu((h @ w.to(bf).float() + b).to(bf)).float()
    w, b = ws[-1], bs[-1]
    if w.shape[1] <= 4:
        return h @ w + b  # the kernels' f32 reduce keeps the weight in f32
    return h @ w.to(bf).float() + b


def _density_of(raw: torch.Tensor, keep: torch.Tensor, avg_density: float) -> torch.Tensor:
    d = avg_density * torch.exp(torch.clamp(raw - 1.0, max=SAFE_EXP_MAX))
    return torch.where(keep, d, 0.0)


def _rgb_of(raw: torch.Tensor, hdr: bool, rgb_bias: float) -> torch.Tensor:
    if hdr:
        return torch.exp(torch.clamp(raw + rgb_bias, max=SAFE_EXP_MAX))
    return torch.sigmoid(raw)


# ---------------------------------------------------------------------------
# K1: proposal density
# ---------------------------------------------------------------------------


def _plain_density(pos_t, ws, bs, *, num_freqs, aabb_lo, aabb_inv_ext, disable_box, avg_density):
    """Twin of the density kernel: pos_t (3, M) -> density (M,)."""
    x2, keep = _contract_and_select(pos_t, aabb_lo, aabb_inv_ext, disable_box)
    raw = _kernel_mlp(_freq_rows(x2, num_freqs).T, ws, bs)
    return _density_of(raw[:, 0], keep, avg_density)


def _check_freqs(w0: torch.Tensor, num_freqs: int) -> None:
    """The first layer must take the 3 + 6F encoding the kernel writes."""
    if w0.shape[0] != 3 + 6 * num_freqs:
        raise ValueError(f"first-layer input {w0.shape[0]} is not 3+6F for F={num_freqs}")


def _launch_density(pos_t, ws, bs, *, num_freqs, aabb_lo, aabb_inv_ext, disable_box, avg_density):
    kernels.check_tensor(pos_t, "pos_t", ndim=2, rows=3)
    _check_freqs(ws[0], num_freqs)
    m = pos_t.shape[1]
    pack = kernels.DensityPack(permute_first(ws, num_freqs), bs, device=pos_t.device)
    box = kernels.box_consts(aabb_lo, aabb_inv_ext, disable_box, avg_density)
    out = torch.empty(m, dtype=torch.float32, device=pos_t.device)
    kernels.launch(
        "fused_density",
        kernels.ptr(pos_t), kernels.i64(m), kernels.ptr(pack.buffer), box, kernels.i32(num_freqs),
        kernels.ptr(out),
    )
    return out


class _FusedDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, n_w, pos_t, *wb):
        ctx.cfg, ctx.n_w = cfg, n_w
        ctx.save_for_backward(pos_t, *wb)
        ws, bs = wb[:n_w], wb[n_w:]
        if pos_t.device.type == "cpu":
            return _plain_density(pos_t, ws, bs, **cfg)
        return _launch_density(pos_t, ws, bs, **cfg)

    @staticmethod
    def backward(ctx, g):
        grads = _recompute_grads(
            ctx, lambda x: _plain_density(x[0], x[1:1 + ctx.n_w], x[1 + ctx.n_w:], **ctx.cfg), g
        )
        return (None, None, *grads)


def fused_density(pos_t, ws, bs, num_freqs, aabb_lo, aabb_inv_ext, disable_box, avg_density):
    """pos_t (3, M) world positions -> density (M,) (kernel K1).
    ws/bs: the MLP's (in, out) weights and biases."""
    cfg = dict(num_freqs=num_freqs, aabb_lo=tuple(aabb_lo), aabb_inv_ext=tuple(aabb_inv_ext),
               disable_box=disable_box, avg_density=avg_density)
    return _FusedDensity.apply(cfg, len(ws), pos_t, *ws, *bs)


def _recompute_grads(ctx, fn, *grad_outputs):
    """Backward through the twin: re-run it on the saved inputs and return
    the input gradients autograd asked for."""
    saved = ctx.saved_tensors
    need = ctx.needs_input_grad[len(ctx.needs_input_grad) - len(saved):]
    leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
    with torch.enable_grad():
        outs = fn(leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    wanted = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(outs, wanted, grad_outputs, allow_unused=True))
    return [next(got) if t.requires_grad else None for t in leaves]


# ---------------------------------------------------------------------------
# K2: radiance field (base MLP + SH / appearance head)
# ---------------------------------------------------------------------------


def _plain_field(pos_t, dirs_t, emb, bws, bbs, hws, hbs, *, num_freqs, aabb_lo,
                 aabb_inv_ext, disable_box, avg_density, hdr, rgb_bias):
    """Twin of the field kernel: (3, M) positions and unit directions and
    one appearance vector (E,) -> (density (M,), rgb_t (3, M))."""
    x2, keep = _contract_and_select(pos_t, aabb_lo, aabb_inv_ext, disable_box)
    base = _kernel_mlp(_freq_rows(x2, num_freqs).T, bws, bbs)  # (M, 1 + geo)
    density = _density_of(base[:, 0], keep, avg_density)
    m = pos_t.shape[1]
    h_in = torch.cat([_sh4_rows(dirs_t).T, base[:, 1:], emb[None, :].expand(m, -1)], dim=1)
    rgb = _rgb_of(_kernel_mlp(h_in, hws, hbs), hdr, rgb_bias)
    return density, rgb.T


def _launch_field(pos_t, dirs_t, emb, bws, bbs, hws, hbs, *, num_freqs, aabb_lo,
                  aabb_inv_ext, disable_box, avg_density, hdr, rgb_bias):
    kernels.check_tensor(pos_t, "pos_t", ndim=2, rows=3)
    m = pos_t.shape[1]
    kernels.check_tensor(dirs_t, "dirs_t", ndim=2, rows=3, cols=m)
    kernels.check_tensor(emb, "emb", ndim=1)
    _check_freqs(bws[0], num_freqs)
    field = kernels.FieldPack(permute_first(bws, num_freqs), bbs, hws, hbs, emb.shape[0],
                              device=pos_t.device)
    box = kernels.box_consts(aabb_lo, aabb_inv_ext, disable_box, avg_density)
    dens = torch.empty(m, dtype=torch.float32, device=pos_t.device)
    rgb = torch.empty(3, m, dtype=torch.float32, device=pos_t.device)
    kernels.launch(
        "fused_field",
        kernels.ptr(pos_t), kernels.ptr(dirs_t), kernels.ptr(emb), kernels.i32(emb.shape[0]),
        kernels.i64(m), *field.args(), box, kernels.i32(num_freqs), kernels.i32(int(hdr)),
        kernels.f32(rgb_bias), kernels.ptr(dens), kernels.ptr(rgb),
    )
    return dens, rgb


class _FusedField(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, n_base, n_head, pos_t, dirs_t, emb, *wb):
        ctx.cfg, ctx.n_base, ctx.n_head = cfg, n_base, n_head
        ctx.save_for_backward(pos_t, dirs_t, emb, *wb)
        args = _split_field(wb, n_base, n_head)
        if pos_t.device.type == "cpu":
            return _plain_field(pos_t, dirs_t, emb, *args, **cfg)
        return _launch_field(pos_t, dirs_t, emb, *args, **cfg)

    @staticmethod
    def backward(ctx, g_dens, g_rgb):
        def fn(x):
            return _plain_field(x[0], x[1], x[2], *_split_field(x[3:], ctx.n_base, ctx.n_head), **ctx.cfg)

        grads = _recompute_grads(ctx, fn, g_dens, g_rgb)
        return (None, None, None, *grads)


def _split_field(wb, n_base, n_head):
    bws, bbs = wb[:n_base], wb[n_base:2 * n_base]
    hws, hbs = wb[2 * n_base:2 * n_base + n_head], wb[2 * n_base + n_head:]
    return bws, bbs, hws, hbs


def fused_field(pos_t, dirs_t, emb, bws, bbs, hws, hbs, num_freqs, aabb_lo, aabb_inv_ext,
                disable_box, avg_density, hdr, rgb_bias):
    """pos_t/dirs_t (3, M), emb (E,) one camera's appearance vector ->
    (density (M,), rgb_t (3, M)) (kernel K2). Weights are (in, out)."""
    cfg = dict(num_freqs=num_freqs, aabb_lo=tuple(aabb_lo), aabb_inv_ext=tuple(aabb_inv_ext),
               disable_box=disable_box, avg_density=avg_density, hdr=hdr, rgb_bias=rgb_bias)
    return _FusedField.apply(cfg, len(bws), len(hws), pos_t, dirs_t, emb, *bws, *bbs, *hws, *hbs)


# ---------------------------------------------------------------------------
# the staged emitter query (mirrors NerfactoModel's hdr_radiance_only path)
# ---------------------------------------------------------------------------


def named_params(params_or_model) -> dict[str, torch.Tensor]:
    """A model's parameters by name, or the given {name: tensor} dict."""
    if isinstance(params_or_model, nn.Module):
        return dict(params_or_model.named_parameters())
    return params_or_model


def _mlp_params(p: dict, prefix: str):
    """(weights (in, out), biases) of the MLP at `prefix`; the layer count
    comes from the parameter names themselves."""
    n_hidden = sum(1 for k in p if k.startswith(f"{prefix}.hidden_") and k.endswith(".weight"))
    names = [f"hidden_{i}" for i in range(n_hidden)] + ["out"]
    ws = tuple(p[f"{prefix}.{n}.weight"].t() for n in names)
    bs = tuple(p[f"{prefix}.{n}.bias"] for n in names)
    return ws, bs


def _freqs_of(w0: torch.Tensor) -> int:
    """Octave count implied by a first-layer (in, out) weight: 3 + 6F rows."""
    rows = w0.shape[0]
    if (rows - 3) % 6:
        raise ValueError(f"first-layer input {rows} is not 3+6F")
    return (rows - 3) // 6


class _QueryConfig:
    """Static configuration the query builders share."""

    def __init__(self, model, disable_box, device):
        if model.implementation != "freq":
            raise ValueError("the kernel query is freq-only")
        if not model.use_fake_contraction:
            # the kernels hard-code the affine (fake) contraction; the model
            # would contract nonlinearly, so the two would disagree
            raise ValueError("the kernel query needs use_fake_contraction=True")
        device = resolve_device(device)
        if model.device.type != device.type:
            raise ValueError(f"model is on {model.device}, query built for {device}")
        self.aabb_lo = tuple(float(x) for x in model.aabb[0])
        self.aabb_inv_ext = tuple(1.0 / (hi - lo) for lo, hi in zip(model.aabb[0], model.aabb[1]))
        self.dbox = (
            tuple(tuple(float(x) for x in row) for row in disable_box)
            if disable_box is not None else None
        )
        self.n_prop = list(model.num_proposal_samples)
        self.n_nerf = model.num_nerf_samples
        self.has_emb = model.appearance_embedding_dim > 0
        self.hdr, self.rgb_bias = model.hdr, model.rgb_bias

    def embedding(self, p: dict, camera_index, device) -> torch.Tensor:
        if not self.has_emb:
            return torch.zeros(0, dtype=torch.float32, device=device)
        table = p["field.appearance_embedding.weight"]
        return table[camera_index if camera_index is not None else 0]


def check_staged_shapes(p: dict) -> None:
    """Raise ValueError unless K1 and K2 take the model of named parameters
    `p`: each proposal MLP fits the wgmma density block
    (`kernels.check_density_widths`) and the field the wgmma field
    (`kernels.check_field_widths`)."""
    for lvl in range(2):
        kernels.check_density_widths([w.shape for w in _mlp_params(p, f"proposal_{lvl}.mlp")[0]])
    kernels.check_field_widths([w.shape for w in _mlp_params(p, "field.base_mlp")[0]],
                               [w.shape for w in _mlp_params(p, "field.head_mlp")[0]])


def _staged_query(cfg: _QueryConfig, p: dict, rays, camera_index, field_twin: bool):
    """The staged query's answer (n, 3). K1 places the samples of both
    proposal levels; the field stage runs K2, or with `field_twin` its twin
    `_plain_field`, for a caller that differentiates the answer (a
    backward reads nothing of K2's output: `_FusedField` recomputes through
    the twin)."""

    def positions_t(rs):
        mid = (rs.frustums.starts + rs.frustums.ends) / 2.0  # (N, S)
        o = rays.origins.T[:, :, None]
        d = rays.directions.T[:, :, None]
        return (o + d * mid[None]).reshape(3, -1)

    rs = spaced_sample(rays, cfg.n_prop[0])
    weights = None
    for lvl in range(2):
        if lvl > 0:
            rs = sample_pdf(rays, rs, weights, cfg.n_prop[lvl])
        ws, bs = _mlp_params(p, f"proposal_{lvl}.mlp")
        dens = fused_density(
            positions_t(rs), ws, bs, _freqs_of(ws[0]),
            cfg.aabb_lo, cfg.aabb_inv_ext, cfg.dbox, 1.0,
        ).reshape(rs.frustums.starts.shape)
        weights = rs.get_weights(dens)

    rs = sample_pdf(rays, rs, weights, cfg.n_nerf)
    bws, bbs = _mlp_params(p, "field.base_mlp")
    hws, hbs = _mlp_params(p, "field.head_mlp")
    emb = cfg.embedding(p, camera_index, rays.origins.device)
    n, s = rs.frustums.starts.shape
    dirs_t = rays.directions.T[:, :, None].expand(3, n, s).reshape(3, -1)
    kw = dict(num_freqs=_freqs_of(bws[0]), aabb_lo=cfg.aabb_lo, aabb_inv_ext=cfg.aabb_inv_ext,
              disable_box=cfg.dbox, avg_density=1.0, hdr=cfg.hdr, rgb_bias=cfg.rgb_bias)
    field = _plain_field if field_twin else fused_field
    dens, rgb_t = field(positions_t(rs), dirs_t, emb, bws, bbs, hws, hbs, **kw)
    rgb_s = rgb_t.reshape(3, n, s)
    w = rs.get_weights(dens.reshape(n, s))
    comp = torch.sum(w[None] * rgb_s, dim=-1)  # (3, N)
    acc = torch.sum(w, dim=-1)
    # background_color='last_sample' HDR completion
    return (comp + rgb_s[..., -1] * (1.0 - acc)[None]).T


def make_fused_radiance_query(model, *, disable_box=None, device=None):
    """Build query(params_or_model, rays, camera_index=None) -> rgb (n, 3):
    the kernel equivalent of model(rays, hdr_radiance_only=True,
    disable_aabb=disable_box, disable_aabb_on=True).

    All rays share one camera (`camera_index`, None -> camera 0): the
    emitter query serves one takeover image at a time. `device=None` means
    CUDA and raises without it. MLP widths that K1 or K2 do not take raise
    ValueError here (`check_staged_shapes`).

    `query.recompute(params, rays, camera_index)` is the same answer with
    the field stage through its twin, the graph a backward differentiates
    (the mega query's backward builds it)."""
    cfg = _QueryConfig(model, disable_box, device)
    check_staged_shapes(named_params(model))

    def query(params_or_model, rays, camera_index=None):
        return _staged_query(cfg, named_params(params_or_model), rays, camera_index, field_twin=False)

    def recompute(params_or_model, rays, camera_index=None):
        return _staged_query(cfg, named_params(params_or_model), rays, camera_index, field_twin=True)

    query.recompute = recompute
    return query


@functools.lru_cache(maxsize=None)
def _fmajor_index(num_freqs: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(fmajor_permutation(num_freqs), device=device)


def permute_first(ws, num_freqs):
    """Permute the first-layer (in, out) rows to the f-major encoding. The
    index is made once per (F, device): copied from a host list on every
    call, it would synchronise the stream ahead of each launch."""
    return (ws[0][_fmajor_index(num_freqs, ws[0].device)],) + tuple(ws[1:])
