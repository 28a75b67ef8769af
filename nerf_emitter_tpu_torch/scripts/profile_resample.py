"""Standalone timing of the two-level inverse-CDF resample (P3) in its two
forms (port of scripts/profile_resample.py): "ramp", the TPU kernel's
telescoped ReLU-ramp sum (the reference's `scalar-u`, whose `scalar-u-mxu`
variant only moves the same sum's row reduce onto the TPU's matrix unit),
and "walk", K3's resample (a CDF segment search per u, one warp a ray).
Prints each form's time and its max |diff|
against the ramp form:

    python -m nerf_emitter_tpu_torch.scripts.profile_resample
"""

from __future__ import annotations

import argparse

import torch

from ..ops.resample import FORMS, resample
from ..utils.device import resolve_device
from .profiling import N_ITERS, NUM_RAYS, device_name, timer

S0, S1, S2 = 256, 96, 48


def inputs(device=None, num_rays: int = NUM_RAYS, seed: int = 0):
    """The reference script's inputs: weights uniform in [0, 0.01) over
    uniform spacing bins, (S0, N), (S0+1, N), (S1, N), (S1+1, N)."""
    dev = resolve_device(device)
    g = torch.Generator(device="cpu").manual_seed(seed)
    w0 = torch.rand((S0, num_rays), generator=g) * 0.01
    w1 = torch.rand((S1, num_rays), generator=g) * 0.01
    sb0 = torch.linspace(0.0, 1.0, S0 + 1)[:, None].expand(S0 + 1, num_rays)
    sb1 = torch.linspace(0.0, 1.0, S1 + 1)[:, None].expand(S1 + 1, num_rays)
    return tuple(t.to(dev).contiguous() for t in (w0, sb0, w1, sb1))


def run(args: tuple, iters: int = N_ITERS) -> dict:
    """ms per call of each form, and each form's max |diff| against the
    ramp form, on the inputs' device."""
    device = args[0].device
    timed = timer(device, iters)
    with torch.no_grad():
        ref = resample(*args, n_out=S2, form="ramp")
        diff = {form: float((resample(*args, n_out=S2, form=form) - ref).abs().max()) for form in FORMS}
    return dict(device=device_name(device), rays=args[0].shape[1], iters=iters,
                ms={form: timed(lambda f=form: resample(*args, n_out=S2, form=f)) for form in FORMS},
                max_abs_diff_vs_ramp=diff)


def report(res: dict) -> str:
    lines = []
    for form, t in res["ms"].items():
        if form != "ramp":
            lines.append(f"  max |diff| vs ramp: {res['max_abs_diff_vs_ramp'][form]:.2e}")
        lines.append(f"{form:12s}: {t:8.2f} ms")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(report(run(inputs(seed=args.seed))), flush=True)


if __name__ == "__main__":
    main()
