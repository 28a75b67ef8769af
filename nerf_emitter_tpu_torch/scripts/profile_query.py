"""Per-kernel timing of the emitter query on the card (port of
scripts/profile_query.py).

Times, at the reference script's configuration (2^16 rays, 256/96
proposals + 48 nerf samples): K3 alone (kernel A), K4 alone on random
sorted bins (kernel B), K3 then K4 on K3's bins (the two-kernel form of
the query's answer), the query (K5), the staged query, and the
host-visible overhead two-kernel - (A + B):

    python -m nerf_emitter_tpu_torch.scripts.profile_query
"""

from __future__ import annotations

import argparse

from ..ops.fused_field import make_fused_radiance_query
from ..ops.mega_query import field_composite, make_mega_radiance_query, proposal_bins
from .profiling import N_ITERS, ProfileSetup, device_name, timer


def kernel_a(s: ProfileSetup):
    return proposal_bins(*s.rows, *s.props, **s.k3)


def kernel_b(s: ProfileSetup):
    return field_composite(s.random_bins, *s.rows, s.emb, *s.field, **s.k4)


def two_kernel(s: ProfileSetup):
    return field_composite(kernel_a(s), *s.rows, s.emb, *s.field, **s.k4)


def run(s: ProfileSetup, iters: int = N_ITERS) -> dict:
    """The script's times (ms per call) on s's device."""
    timed = timer(s.device, iters)
    res = dict(device=device_name(s.device), rays=s.rows[0].shape[1], iters=iters,
               kernel_a_ms=timed(lambda: kernel_a(s)), kernel_b_ms=timed(lambda: kernel_b(s)))
    res["two_kernel_ms"] = timed(lambda: two_kernel(s))
    res["overhead_ms"] = res["two_kernel_ms"] - res["kernel_a_ms"] - res["kernel_b_ms"]
    pipe = make_mega_radiance_query(s.model, device=s.device)
    res["pipelined_ms"] = timed(lambda: pipe(s.model, s.rays))
    staged = make_fused_radiance_query(s.model, device=s.device)
    res["staged_ms"] = timed(lambda: staged(s.model, s.rays))
    n = res["rays"]
    res["rays_per_s_two_kernel"] = n / res["two_kernel_ms"] * 1e3
    res["rays_per_s_pipelined"] = n / res["pipelined_ms"] * 1e3
    return res


def report(res: dict) -> str:
    lines = [
        f"kernel A (proposals):      {res['kernel_a_ms']:8.2f} ms",
        f"kernel B (field+composite):{res['kernel_b_ms']:8.2f} ms",
        f"mega query (two kernels):  {res['two_kernel_ms']:8.2f} ms",
        f"  overhead (full - A - B): {res['overhead_ms']:8.2f} ms",
        f"mega query (pipelined):    {res['pipelined_ms']:8.2f} ms",
        f"staged query:              {res['staged_ms']:8.2f} ms",
        f"rays/s (mega 2-kernel):    {res['rays_per_s_two_kernel']:,.0f}",
        f"rays/s (mega pipelined):   {res['rays_per_s_pipelined']:,.0f}",
    ]
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(report(run(ProfileSetup(seed=args.seed))), flush=True)


if __name__ == "__main__":
    main()
