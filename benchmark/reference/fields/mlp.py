"""Plain MLP with flax `Dense(dtype=bfloat16)` semantics (port of
nerf_emitter_tpu/fields/mlp.py).

Each layer rounds its input and weight to bf16, takes the product with f32
accumulation, rounds it to bf16 and adds the bias in bf16, as flax does;
parameters stay f32 and the output is cast back to f32. The kernels'
arithmetic differs (bias added in f32 before the bf16 rounding), which is
why the reference compares the two paths at rtol 2e-2.

The weight and bias gradients are rounded to bf16 too (the backward of
the casts). A step split over ranks sets `defer_grad_rounding`: each rank's
gradients are then its rows' f32 sums, which the step sums over the ranks
and rounds to bf16 once (`round_to_bf16_`), as one rank rounds its sum; the
forward is the same either way.

A frozen copy of the port's fields/mlp.py for the benchmark's reference.
Departure: `operand_precision = "fp8"` (the benchmark's control) rounds
each layer's operands to float8 e4m3 in place of bf16.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default Dense init (truncated lecun normal) for an
    nn.Linear-layout (out, in) weight."""
    std = 1.0 / math.sqrt(weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _bf16_straight_through(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as f32 (x + (r - x) is r exactly); the gradient
    passes as it is, in f32, not rounded."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def round_to_bf16_(tensors) -> None:
    """Round each tensor to bf16 in place (kept f32)."""
    with torch.no_grad():
        for t in tensors:
            t.copy_(t.to(torch.bfloat16).float())


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (amax to 448, the
    format's largest normal), as f32: what an fp8 matmul's operand
    holds. The gradient passes as it is (straight through)."""
    with torch.no_grad():
        scale = 448.0 / torch.clamp(x.abs().amax(), min=1e-30)
        q = (x * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x).detach()


class MLP(nn.Module):
    """num_layers Linear layers (hidden_0 .. hidden_{L-2}, out) of width
    layer_width with ReLU between them. Linear weights are (out, in), drawn
    from `generator` (on `device`) when one is given, else from torch's
    global generator."""

    defer_grad_rounding = False  # see the module's docstring
    # the benchmark's control: "fp8" rounds each layer's operands to
    # float8 e4m3 (fp8_round) in place of bf16, the precision below the
    # configuration's; "bf16" is the configuration's own
    operand_precision = "bf16"

    def __init__(self, in_dim: int, out_dim: int, num_layers: int = 3, layer_width: int = 64,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        dims = [in_dim] + [layer_width] * (num_layers - 1) + [out_dim]
        names = [f"hidden_{i}" for i in range(num_layers - 1)] + ["out"]
        self.layer_names = names
        for name, k, n in zip(names, dims[:-1], dims[1:]):
            lin = nn.Linear(k, n, device=device)
            lecun_normal_(lin.weight, generator)
            nn.init.zeros_(lin.bias)
            self.add_module(name, lin)

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, n) for n in self.layer_names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf = torch.bfloat16
        h = x.to(bf)
        layers = self.layers()
        if self.operand_precision == "fp8":
            h = x
            for i, lin in enumerate(layers):
                h = fp8_round(h) @ fp8_round(lin.weight).T + lin.bias
                if i < len(layers) - 1:
                    h = torch.relu(h)
            return h.float()
        for i, lin in enumerate(layers):
            if self.defer_grad_rounding:
                prod = (h.float() @ _bf16_straight_through(lin.weight).T).to(bf)
                h = prod + _bf16_straight_through(lin.bias).expand(prod.shape).to(bf)
            else:
                prod = (h.float() @ lin.weight.to(bf).float().T).to(bf)
                h = prod + lin.bias.to(bf)
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h.float()
