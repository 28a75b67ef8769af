"""P3 (`resample`): the two-level inverse-CDF resample of given weights, the
profiling kernel of scripts/profile_resample.py, in its two forms (port of
its `make_kernel` over `resample_scalar_u`). csrc/resample.cu.

From weights w0 (S0, N) over spacing bins sb0 (S0+1, N):
sb1' = R(w0, sb0, S1) with S1 = w1.shape[0]; then out = R(w1, sb1', n_out),
(n_out+1, N). The fourth input sb1 (S1+1, N) is taken for the script's
signature and never read, as in the script's kernel body.

Forms of R: "ramp" is the TPU's telescoped ReLU-ramp sum (the script's
`scalar-u`; its `scalar-u-mxu` variant computes the same sum with the row
reduce on the TPU's matrix unit); "walk" is K3's resample (each u's CDF
segment found and interpolated within, one warp a ray). The two agree
to the ramp's cancellation error, ~1e-4 of the spacing range.
"""

from __future__ import annotations

import torch

from .. import kernels
from .mega_query import _EPS, _HIST_PAD, _resample_rows

FORMS = ("ramp", "walk")  # csrc/resample.cu ResampleForm


def _resample_ramp_rows(weights: torch.Tensor, sbins: torch.Tensor, n_out: int) -> torch.Tensor:
    """The ramp form of R: (S, R) weights and (S+1, R) spacing bins ->
    (n_out+1, R) bins, as the sum over segments s of
    coef[s] relu(u_i - cdf[s]) with coef the telescoped slopes."""
    s_in, r = weights.shape
    w = weights + _HIST_PAD
    w_sum = w.sum(dim=0, keepdim=True)
    padding = (_EPS - w_sum).clamp(min=0.0)
    pdf = (w + padding / s_in) / (w_sum + padding)
    incl = torch.cumsum(pdf, dim=0)
    cdf = torch.cat([torch.zeros_like(incl[:1]), incl[:-1].clamp(max=1.0), torch.ones_like(incl[:1])])
    g = (sbins[1:] - sbins[:-1]) / (cdf[1:] - cdf[:-1]).clamp(min=_EPS)
    zero = torch.zeros_like(g[:1])
    coef = torch.cat([g, zero]) - torch.cat([zero, g])
    step = (1.0 - _EPS) / n_out
    rows = [torch.sum(coef * (float(i * step + 1.0 / (2.0 * (n_out + 1))) - cdf).clamp(min=0.0), dim=0)
            for i in range(n_out + 1)]
    return sbins[:1] + torch.stack(rows)


def _plain_resample(w0, sb0, w1, sb1, *, n_out, form):
    """Twin of the resample kernel (sb1 unread)."""
    fn = _resample_ramp_rows if form == "ramp" else _resample_rows
    return fn(w1, fn(w0, sb0, w1.shape[0]), n_out)


def resample(w0, sb0, w1, sb1, *, n_out=48, form="ramp"):
    """Kernel P3: w0 (S0, N), sb0 (S0+1, N), w1 (S1, N), sb1 (S1+1, N) ->
    (n_out+1, N) spacing bins, `form` in FORMS. The twin serves CPU
    tensors; a CUDA tensor launches the kernel."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if w0.device.type == "cpu":
        return _plain_resample(w0, sb0, w1, sb1, n_out=n_out, form=form)
    s0, n = w0.shape
    s1 = w1.shape[0]
    kernels.check_tensor(w0, "w0", ndim=2)
    kernels.check_tensor(sb0, "sb0", ndim=2, rows=s0 + 1, cols=n)
    kernels.check_tensor(w1, "w1", ndim=2, cols=n)
    kernels.check_tensor(sb1, "sb1", ndim=2, rows=s1 + 1, cols=n)
    out = torch.empty(n_out + 1, n, dtype=torch.float32, device=w0.device)
    kernels.launch(
        "resample", kernels.i32(FORMS.index(form)), kernels.ptr(w0), kernels.ptr(sb0),
        kernels.ptr(w1), kernels.i64(n), kernels.i32(s0), kernels.i32(s1), kernels.i32(n_out),
        kernels.ptr(out), count_as=f"resample[{form}]",
    )
    return out
