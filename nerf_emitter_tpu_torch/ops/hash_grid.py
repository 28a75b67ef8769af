"""K7 (`hash_grid`): the multiresolution hash encoding of the `hash` fields
as a differentiable function, csrc/hash_grid.cu.

`hash_grid(table, positions, spec)`: the flat (T, 2) f32 table of a
fields/encodings.HashGridSpec and unit positions (N, 3) -> features
(N, L*2), as fields/encodings.hash_encode gives them (positions clamped to
[0, 1], trilinear weights of each level's 8 corners, level-major). An
autograd Function in the `setup_context` form, with a backward (the
table's gradient, and the positions' where they require one) and a jvp,
so that `torch.func.jvp` runs through it (`NerfactoModel.point_lights`).

A CUDA tensor launches the kernel's three launchers: the forward (the jvp
through its tangent mode), the table's gradient by atomics, the positions'
gradient. A CPU tensor takes the plain twins below, which are
`hash_encode` itself: its forward, autograd's backward through it, and
`torch.func.jvp` through it for the tangent.

With the port's tracing on, the forward and backward are the spans
`encoding.forward` and `encoding.backward` (the backward runs on
autograd's thread, so its launches sit inside its own span), and the
counters `encoding.points` (points encoded), `encoding.lookups` (points x
levels x 8 corners x features, the benchmark yardstick's unit) and
`encoding.grad_points` (points through the backward).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..fields.encodings import HashGridSpec, hash_encode
from ..utils import profiler

FEATURES = 2  # the kernel's features a level (one float2 a row)
CORNERS = 8


# ---------------------------------------------------------------------------
# the plain twins (CPU tensors)
# ---------------------------------------------------------------------------


def _plain_grads(table, positions, grad_out, spec, need_table=True, need_positions=True):
    """Twin of the backward: autograd through `hash_encode`. (table's
    gradient or None, positions' gradient or None)."""
    with torch.enable_grad():
        t = table.detach().requires_grad_(need_table)
        p = positions.detach().requires_grad_(need_positions)
        grads = iter(torch.autograd.grad(hash_encode(t, p, spec), [x for x in (t, p) if x.requires_grad], grad_out))
    return (next(grads) if need_table else None), (next(grads) if need_positions else None)


def _plain_tangent(table, positions, tangent, spec):
    """Twin of the forward's tangent mode: forward mode through
    `hash_encode`."""
    return torch.func.jvp(lambda p: hash_encode(table, p, spec), (positions,), (tangent,))[1]


# ---------------------------------------------------------------------------
# the kernel (CUDA tensors)
# ---------------------------------------------------------------------------


def _check(table, positions, spec, *more):
    if spec.features_per_level != FEATURES:
        raise ValueError(f"hash grid kernel: {FEATURES} features a level, got {spec.features_per_level}")
    kernels.check_tensor(table, "table", ndim=2, rows=spec.total_size, cols=FEATURES)
    kernels.check_tensor(positions, "positions", ndim=2, cols=3)
    for name, t, cols in more:
        kernels.check_tensor(t, name, ndim=2, rows=positions.shape[0], cols=cols)


def _ptr(t):
    return None if t is None else kernels.ptr(t)


def _kernel_forward(table, positions, spec, tangent=None, primal=True):
    """(features or None, tangent of the features or None)."""
    n = positions.shape[0]
    _check(table, positions, spec, *([("tangent", tangent, 3)] if tangent is not None else []))
    shape = (n, spec.out_dim)
    out = torch.empty(shape, dtype=torch.float32, device=positions.device) if primal else None
    dout = torch.empty(shape, dtype=torch.float32, device=positions.device) if tangent is not None else None
    kernels.launch("hash_grid_forward", kernels.ptr(table), kernels.ptr(positions), _ptr(tangent), kernels.i64(n),
                   kernels.ptr(spec.level_table(positions.device)), kernels.i32(spec.num_levels),
                   kernels.i64(spec.total_size), _ptr(out), _ptr(dout),
                   count_as="hash_grid_forward" if tangent is None else "hash_grid_forward[jvp]")
    return out, dout


def _kernel_table_grad(table, positions, grad_out, spec):
    _check(table, positions, spec, ("grad_out", grad_out, spec.out_dim))
    g = torch.zeros_like(table)
    kernels.launch("hash_grid_backward", kernels.ptr(positions), kernels.ptr(grad_out),
                   kernels.i64(positions.shape[0]), kernels.ptr(spec.level_table(positions.device)),
                   kernels.i32(spec.num_levels), kernels.i64(spec.total_size), kernels.ptr(g))
    return g


def _kernel_positions_grad(table, positions, grad_out, spec):
    _check(table, positions, spec, ("grad_out", grad_out, spec.out_dim))
    g = torch.zeros_like(positions)
    kernels.launch("hash_grid_positions_backward", kernels.ptr(table), kernels.ptr(positions),
                   kernels.ptr(grad_out), kernels.i64(positions.shape[0]),
                   kernels.ptr(spec.level_table(positions.device)), kernels.i32(spec.num_levels),
                   kernels.i64(spec.total_size), kernels.ptr(g))
    return g


# ---------------------------------------------------------------------------
# the function
# ---------------------------------------------------------------------------


class _HashGrid(torch.autograd.Function):
    @staticmethod
    def forward(table, positions, spec):
        with profiler.span("encoding.forward"):
            n = positions.shape[0]
            profiler.count("encoding.points", n)
            profiler.count("encoding.lookups", n * spec.num_levels * CORNERS * spec.features_per_level)
            if positions.device.type == "cpu":
                return hash_encode(table, positions, spec)
            return _kernel_forward(table, positions, spec)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, positions, spec = inputs
        ctx.spec = spec
        ctx.save_for_backward(table, positions)
        ctx.save_for_forward(table, positions)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        with profiler.span("encoding.backward"):
            table, positions = ctx.saved_tensors
            need_table, need_positions = ctx.needs_input_grad[:2]
            profiler.count("encoding.grad_points", positions.shape[0])
            grad_out = grad_out.contiguous()
            if positions.device.type == "cpu":
                g_table, g_pos = _plain_grads(table, positions, grad_out, ctx.spec, need_table, need_positions)
            else:
                g_table = _kernel_table_grad(table, positions, grad_out, ctx.spec) if need_table else None
                g_pos = _kernel_positions_grad(table, positions, grad_out, ctx.spec) if need_positions else None
        return g_table, g_pos, None

    @staticmethod
    def jvp(ctx, table_t, positions_t, _):
        # under torch.func the saved tensors and tangents are the
        # transform's wrappers, which hold no storage: the launches go
        # through Functions, whose forward sees the tensors they wrap
        table, positions = ctx.saved_tensors
        out = None
        if positions_t is not None:
            out = _HashGridTangent.apply(table, positions, positions_t.contiguous(), ctx.spec)
        if table_t is not None:  # the features are linear in the table
            part = _HashGrid.apply(table_t.contiguous(), positions, ctx.spec)
            out = part if out is None else out + part
        return out


class _HashGridTangent(torch.autograd.Function):
    """The forward's tangent by the positions (the kernel's tangent mode),
    for `_HashGrid.jvp`; not differentiated further."""

    @staticmethod
    def forward(table, positions, tangent, spec):
        if positions.device.type == "cpu":
            return _plain_tangent(table, positions, tangent, spec)
        return _kernel_forward(table, positions, spec, tangent=tangent, primal=False)[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


def hash_grid(table: torch.Tensor, positions: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Unit positions (N, 3) -> features (N, L*F) of the flat (T, F) table
    of `spec`; differentiable in both (backward and forward mode)."""
    return _HashGrid.apply(table, positions.contiguous(), spec)
