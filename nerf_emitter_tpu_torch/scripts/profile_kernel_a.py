"""Breakdown of K3 (kernel A, the proposals): density MLPs against
resampling (port of scripts/profile_kernel_a.py).

Modes of the P2 kernel (same inputs and output, pieces stubbed out):
  full          : K3 itself
  dens-only     : both density passes and weights, resamples replaced by
                  uniform bins
  resample-only : densities replaced by 0.3 x the far bin edge, resamples
                  kept

    python -m nerf_emitter_tpu_torch.scripts.profile_kernel_a
"""

from __future__ import annotations

import argparse

from ..ops.mega_query import PROPOSAL_MODES, proposal_variant
from .profiling import N_ITERS, ProfileSetup, device_name, timer


def variant(s: ProfileSetup, mode: str):
    return proposal_variant(*s.rows, *s.props, mode=mode, **s.k3)


def run(s: ProfileSetup, iters: int = N_ITERS) -> dict:
    """ms per call of each mode on s's device."""
    timed = timer(s.device, iters)
    return dict(device=device_name(s.device), rays=s.rows[0].shape[1], iters=iters,
                ms={mode: timed(lambda m=mode: variant(s, m)) for mode in PROPOSAL_MODES})


def report(res: dict) -> str:
    return "\n".join(f"{mode:14s}: {t:8.2f} ms" for mode, t in res["ms"].items())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(report(run(ProfileSetup(seed=args.seed))), flush=True)


if __name__ == "__main__":
    main()
