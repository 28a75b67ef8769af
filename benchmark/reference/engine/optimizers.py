"""Per-group optimizers (port of nerf_emitter_tpu/engine/optimizers.py).

The reference's `optax.multi_transform` of one chain per group becomes one
`torch.optim.Adam` per group with a `LambdaLR` of its schedule. A group's
step runs the chain in the reference's order: `max_value` clips each
gradient element, `max_norm` then clips the group's global norm, and
`weight_decay` is added to the gradient before Adam
(`optax.add_decayed_weights`, which is torch Adam's coupled
`weight_decay`, not AdamW).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from .schedulers import exponential_decay_schedule


@dataclasses.dataclass(frozen=True)
class OptimizerGroupConfig:
    lr: float = 1e-2
    eps: float = 1e-15
    lr_final: Optional[float] = None
    max_steps: int = 100000
    warmup_steps: int = 0
    max_norm: Optional[float] = None
    max_value: Optional[float] = None
    step_pretrain: Optional[int] = None
    lr_lambda: float = 1.0
    weight_decay: float = 0.0

    def schedule(self) -> Callable[[int], float]:
        return exponential_decay_schedule(self.lr, self.lr_final, self.max_steps, self.warmup_steps,
                                          step_pretrain=self.step_pretrain, lr_lambda=self.lr_lambda)


class GroupOptimizer:
    """One group's chain: clipping, Adam (beta 0.9/0.999) and its schedule.
    The update of step k uses schedule(k), as optax's does: the LambdaLR is
    stepped after each Adam step."""

    def __init__(self, config: OptimizerGroupConfig, params: list[torch.nn.Parameter]):
        self.config = config
        self.params = params
        self.adam = torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999), eps=config.eps,
                                     weight_decay=config.weight_decay)
        schedule = config.schedule()
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adam, lambda k: schedule(k) / config.lr)

    @torch.no_grad()
    def clip_(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.config.max_value is not None:
            for g in grads:
                g.clamp_(-self.config.max_value, self.config.max_value)
        if self.config.max_norm is not None and grads:
            # optax.clip_by_global_norm: g / |g| * max_norm once |g| >= max_norm
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.config.max_norm, 1.0, self.config.max_norm / norm)
            for g in grads:
                g.mul_(scale)

    def step(self) -> None:
        self.clip_()
        self.adam.step()
        self.scheduler.step()

    def lr(self) -> float:
        return self.adam.param_groups[0]["lr"]

    def seek(self, count: int) -> None:
        """Put the schedule at step `count`: the learning rate LambdaLR
        would hold after `count` steps."""
        self.scheduler.last_epoch = count
        for group, base, lam in zip(self.adam.param_groups, self.scheduler.base_lrs, self.scheduler.lr_lambdas):
            group["lr"] = base * lam(count)

    def state_tree(self) -> dict:
        """The group's state as a tree of tensors that does not change shape
        over training: the schedule's step `count` and, per parameter in
        order, Adam's `step`, `exp_avg` and `exp_avg_sq` (zeros before the
        parameter's first update)."""
        tree = {"count": self.scheduler.last_epoch, "step": [], "exp_avg": [], "exp_avg_sq": []}
        for p in self.params:
            st = self.adam.state.get(p, {})
            tree["step"].append(st["step"].detach().clone() if st else torch.zeros((), dtype=torch.float32))
            for k in ("exp_avg", "exp_avg_sq"):
                tree[k].append(st[k].detach().clone() if st else torch.zeros_like(p))
        return tree

    @torch.no_grad()
    def load_state_tree(self, tree: dict) -> None:
        """The inverse of state_tree: a parameter whose step is 0 has no
        Adam state, as before its first update."""
        self.adam.state.clear()
        for p, step, m, v in zip(self.params, tree["step"], tree["exp_avg"], tree["exp_avg_sq"]):
            if float(step) > 0:
                self.adam.state[p] = {"step": step.detach().clone().cpu(), "exp_avg": m.to(p).clone(),
                                      "exp_avg_sq": v.to(p).clone()}
        self.seek(int(tree["count"]))


class MultiOptimizer:
    """`optax.multi_transform` on torch: named parameters split into groups
    by a label function, one GroupOptimizer per group that has any."""

    def __init__(self, groups: dict[str, GroupOptimizer]):
        self.groups = groups

    def zero_grad(self) -> None:
        for grp in self.groups.values():
            grp.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for grp in self.groups.values():
            grp.step()

    def lrs(self) -> dict[str, float]:
        return {name: grp.lr() for name, grp in self.groups.items()}

    def state_tree(self) -> dict:
        """{group: GroupOptimizer.state_tree()}."""
        return {name: grp.state_tree() for name, grp in self.groups.items()}

    def load_state_tree(self, tree: dict) -> None:
        for name, grp in self.groups.items():
            grp.load_state_tree(tree[name])


def build_optimizer(
    group_configs: dict[str, OptimizerGroupConfig],
    named_params: Iterable[tuple[str, torch.nn.Parameter]],
    label_fn: Optional[Callable[[str], str]] = None,
) -> MultiOptimizer:
    """group_configs: name -> config; named_params: (name, parameter)
    pairs, e.g. `model.named_parameters()`; label_fn(name) -> group name
    (default: label_params_by_prefix). A label without a config raises."""
    label_fn = label_fn or label_params_by_prefix
    members: dict[str, list] = {name: [] for name in group_configs}
    for name, param in named_params:
        if not param.requires_grad:
            continue
        label = label_fn(name)
        if label not in members:
            raise KeyError(f"parameter {name!r} is labelled {label!r}, which has no optimizer group")
        members[label].append(param)
    return MultiOptimizer({name: GroupOptimizer(group_configs[name], ps) for name, ps in members.items() if ps})


def label_params_by_prefix(name: str, default: str = "fields") -> str:
    """Label by the parameter's top-level module: proposal_* ->
    'proposal_networks', camera_opt* / rotation_opt* -> 'camera_opt',
    everything else -> 'fields'."""
    top = name.split(".")[0]
    if top.startswith("proposal"):
        return "proposal_networks"
    if top.startswith("camera_opt") or top.startswith("rotation_opt"):
        return "camera_opt"
    return default
