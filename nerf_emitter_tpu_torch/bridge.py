"""Carry weights from the JAX package's flax parameter tree into the port.

`tree` is the flax `params` pytree as nested dicts of numpy arrays (for
example `jax.tree.map(np.asarray, params)`), with or without the top-level
"params" key. Dense layers are `<path>/{hidden_i,out}/{kernel (in, out),
bias}`; the port's nn.Linear weight is (out, in), so kernels are
transposed. The appearance table is `field/appearance_embedding/embedding`.
Raw parameters keep their flax names and layout: the hash tables
`field/hash_table` and `proposal_{0,1}/hash_table` (T, F), and the pose
deltas `camera_opt_deltas` and `rotation_opt_deltas` (n, 6). The distilled
student's tree (`hidden_{i}`, `out`) loads into `EmitterLightField` the
same way, and `load_denoiser_params` the learned denoiser's conv kernels
(HWIO to OIHW). `load_sdf_scene` carries an SDF scene's grids, envmap and
guiding mixture; `load_train_state` a NeRF train state (the parameters and
each group's Adam moments) and `load_sdf_opt_state` a takeover state (the
scene, the step, the optimiser's moments and the running means), so that a
test can start both packages from one state. Optimiser states are read by
their optax attribute names (`inner_states`, `inner_state`, `mu`, `nu`,
`count`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

# parameters that sit on no nn.Linear / nn.Embedding, by their own name
_RAW = ("hash_table", "camera_opt_deltas", "rotation_opt_deltas")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _flax_path(module: nn.Module, torch_name: str) -> tuple[str, bool]:
    """torch parameter name -> (flax path, transpose?)."""
    *mods, leaf = torch_name.split(".")
    owner = module.get_submodule(".".join(mods)) if mods else module
    path = "/".join(mods)
    if isinstance(owner, nn.Embedding):
        return f"{path}/embedding", False
    if isinstance(owner, nn.Linear):
        return (f"{path}/kernel", True) if leaf == "weight" else (f"{path}/bias", False)
    if leaf in _RAW:
        return (f"{path}/{leaf}" if path else leaf), False
    raise KeyError(f"no flax counterpart for parameter {torch_name!r}")


def load_flax_params(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy every parameter of `model` from `tree`, in place. Raises
    KeyError on a missing or extra key and ValueError on a shape mismatch,
    so a tree of another depth cannot load silently."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    flat = _flatten(tree)
    wanted = {}
    for name, param in model.named_parameters():
        path, transpose = _flax_path(model, name)
        wanted[path] = (param, transpose)
    missing = sorted(set(wanted) - set(flat))
    extra = sorted(set(flat) - set(wanted))
    if missing or extra:
        raise KeyError(f"flax tree mismatch: missing {missing}, extra {extra}")
    with torch.no_grad():
        for path, (param, transpose) in wanted.items():
            arr = flat[path].T if transpose else flat[path]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(
                    f"{path}: flax shape {flat[path].shape} does not fit "
                    f"parameter shape {tuple(param.shape)}"
                )
            param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model


def load_denoiser_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax KernelPredictor tree (`conv_{i}` and `head`, each a HWIO
    `kernel` and a `bias`, with or without the top-level "params" key) into
    the port's `renderer.learned_denoise.KernelPredictor`, in place: the
    kernels become OIHW. Raises KeyError on a missing or extra layer and
    ValueError on a shape mismatch."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    layers = {f"conv_{i}": conv for i, conv in enumerate(module.convs)} | {"head": module.head}
    if set(tree) != set(layers):
        raise KeyError(f"flax tree mismatch: missing {sorted(set(layers) - set(tree))}, "
                       f"extra {sorted(set(tree) - set(layers))}")
    with torch.no_grad():
        for name, conv in layers.items():
            kernel = np.asarray(tree[name]["kernel"], np.float32).transpose(3, 2, 0, 1)
            bias = np.array(tree[name]["bias"], np.float32)
            if kernel.shape != tuple(conv.weight.shape) or bias.shape != tuple(conv.bias.shape):
                raise ValueError(f"{name}: flax kernel {kernel.shape} / bias {bias.shape} do not fit "
                                 f"{tuple(conv.weight.shape)} / {tuple(conv.bias.shape)}")
            conv.weight.copy_(torch.from_numpy(kernel.copy()))
            conv.bias.copy_(torch.from_numpy(bias))
    return module


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def load_sdf_scene(scene, device=None):
    """The port's SdfScene from another package's scene: any object with
    the attributes sdf, albedo, roughness, envmap (image, row_cdf,
    cond_cdf, or None), guiding (positions, weights, stds, or None),
    bsdf_type and hide_emitters, whose arrays numpy can read (the JAX
    package's SdfScene is one)."""
    from .renderer.emitters import EnvmapEmitter, VMFMixture
    from .renderer.scene import SdfScene

    env, guide = scene.envmap, scene.guiding
    return SdfScene(
        sdf=_tensor(scene.sdf, device), albedo=_tensor(scene.albedo, device),
        roughness=_tensor(scene.roughness, device),
        envmap=None if env is None else EnvmapEmitter(
            *(_tensor(getattr(env, k), device) for k in ("image", "row_cdf", "cond_cdf"))),
        guiding=None if guide is None else VMFMixture(
            *(_tensor(getattr(guide, k), device) for k in ("positions", "weights", "stds"))),
        bsdf_type=int(scene.bsdf_type), hide_emitters=bool(scene.hide_emitters),
    )


def _first(node, has):
    """The first node, depth first, of an optax state tree (tuples,
    mappings, named tuples) for which has(node) holds."""
    if has(node):
        return node
    inner = getattr(node, "inner_state", None)
    children = ([inner] if inner is not None else list(node.values()) if isinstance(node, Mapping)
                else list(node) if isinstance(node, tuple) else [])
    for child in children:
        found = _first(child, has)
        if found is not None:
            return found
    return None


def _field(node, name):
    return node.get(name) if isinstance(node, Mapping) else getattr(node, name, None)


def _is_moments(node) -> bool:
    return all(_field(node, k) is not None for k in ("mu", "nu", "count"))


def load_train_state(model: nn.Module, optimizer, state):
    """The port's TrainState from another package's train state `state`
    (step, params, opt_state; the JAX package's TrainState is one): the
    parameters into `model`, and into each group of `optimizer` (the port's
    MultiOptimizer) the Adam moments and count of that group's optax chain
    and its schedule's count."""
    from .engine.train_loop import TrainState

    load_flax_params(model, state.params)
    names = {id(p): n for n, p in model.named_parameters()}
    for group, grp in optimizer.groups.items():
        # the group's optax chain: a plain tuple (named tuples are states)
        chain = _first(state.opt_state.inner_states[group],
                       lambda n: isinstance(n, tuple) and not hasattr(n, "_fields"))
        moments = _first(chain, _is_moments)
        sched = next(s for s in chain if s is not moments and _field(s, "count") is not None)
        mu = _flatten(_field(moments, "mu").get("params", _field(moments, "mu")))
        nu = _flatten(_field(moments, "nu").get("params", _field(moments, "nu")))
        tree = {"count": int(np.asarray(_field(sched, "count"))), "step": [], "exp_avg": [], "exp_avg_sq": []}
        for p in grp.params:
            path, transpose = _flax_path(model, names[id(p)])
            tree["step"].append(torch.tensor(float(np.asarray(_field(moments, "count"))), dtype=torch.float32))
            for key, flat in (("exp_avg", mu), ("exp_avg_sq", nu)):
                arr = flat[path].T if transpose else flat[path]
                tree[key].append(torch.from_numpy(np.array(arr, dtype=np.float32)).to(p.device))
        grp.load_state_tree(tree)
    return TrainState(step=int(np.asarray(state.step)))


def load_sdf_opt_state(state, tx, device=None):
    """The port's SdfOptState from another package's takeover state (the JAX
    package's SdfOptState): the scene (load_sdf_scene), the step, the
    running means and their count, and `tx`'s state (the port's
    SdfOptimizer of the same recipe) with each variable's moments and count
    from the state's multi_transform label of that name."""
    from .pipelines.sdf_optimizer import SdfOptState

    scene = load_sdf_scene(state.scene, device)

    def fill(port, src, name):
        if isinstance(port, dict) and set(port) == {"mu", "nu", "count"}:
            return {"mu": _tensor(getattr(_field(src, "mu"), name), device),
                    "nu": _tensor(getattr(_field(src, "nu"), name), device),
                    "count": int(np.asarray(_field(src, "count")))}
        if isinstance(port, tuple):
            return tuple(fill(x, src, name) for x in port)
        return port

    opt = {}
    for name, t in tx.txs.items():
        moments = _first(state.opt_state.inner_states[name], _is_moments)
        opt[name] = fill(t.init(getattr(scene, name)), moments, name)
    means = state.mean_params
    return SdfOptState(
        step=int(np.asarray(state.step)), scene=scene, opt_state=opt,
        mean_params=None if means is None else {k: _tensor(v, device) for k, v in means.items()},
        mean_count=int(np.asarray(state.mean_count)))
