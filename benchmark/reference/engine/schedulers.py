"""Learning-rate and proposal-anneal schedules (port of
nerf_emitter_tpu/engine/schedulers.py), as plain functions of the step.

Exponential decay from lr_init to lr_final over max_steps, with an optional
sine warm-up and a hard x`lr_lambda` drop at `step_pretrain` (the takeover
step: the field and proposal learning rates fall x0.01 when the SDF phase
starts).
"""

from __future__ import annotations

import math
from typing import Callable, Optional


def exponential_decay_schedule(
    lr_init: float,
    lr_final: Optional[float] = None,
    max_steps: int = 100000,
    warmup_steps: int = 0,
    lr_pre_warmup: float = 1e-8,
    step_pretrain: Optional[int] = None,
    lr_lambda: float = 1.0,
) -> Callable[[int], float]:
    """Returns f(step) -> lr."""
    lr_fin = lr_init if lr_final is None else lr_final

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            x = min(max(step / warmup_steps, 0.0), 1.0)
            lr = lr_pre_warmup + (lr_init - lr_pre_warmup) * math.sin(0.5 * math.pi * x)
        else:
            t = min(max((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0), 1.0)
            lr = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_fin) * t)
        if step_pretrain is not None and step >= step_pretrain:
            lr = lr * lr_lambda
        return lr

    return schedule


def proposal_anneal_schedule(anneal_steps: int = 1000, slope: float = 10.0) -> Callable[[int], float]:
    """Nerfacto's proposal-weight annealing: bias(clip(step / N), slope)."""

    def schedule(step: int) -> float:
        x = min(max(float(step) / max(anneal_steps, 1), 0.0), 1.0)
        return slope * x / ((slope - 1.0) * x + 1.0)

    return schedule
