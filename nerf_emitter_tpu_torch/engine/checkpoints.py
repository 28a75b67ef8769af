"""Checkpoints in the port's own torch format (port of
nerf_emitter_tpu/engine/checkpoints.py's API; the JAX package writes orbax
checkpoints, which this package does not read).

A state is a tree of dataclasses, dicts, lists, tuples, tensors, Python
scalars and None (the trainer saves {"nerf": train_state_tree(...),
"sdf": SdfOptState}). Step `n` lives in `<directory>/<n>/`: `state.pt`,
the tree with dataclasses as dicts of their fields and every tensor on the
CPU, read back with `torch.load(weights_only=True)`, so values round-trip
bit for bit; and `metadata.json`, the same tree with each tensor replaced
by its shape and dtype, which can be read without loading the state (the
trainer reads the stored SDF resolution from it).

Across ranks (`mesh`) rank 0 alone writes, and every rank waits for the
write (a barrier) before any of them reads; every rank restores.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Any, NamedTuple, Optional

import torch

from ..parallel.mesh import Mesh, barrier

_STATE, _META = "state.pt", "metadata.json"


class ArrayMeta(NamedTuple):
    """A stored tensor's shape and dtype (a leaf of `metadata_tree`)."""

    shape: tuple
    dtype: torch.dtype


def to_tree(obj: Any) -> Any:
    """The tree a save writes: dataclasses as dicts of their fields, every
    tensor detached on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_tree(v) for v in obj)
    return obj


def _to_meta(tree: Any) -> Any:
    """JSON for the tree: a tensor as {"__array__": {shape, dtype}}; tuples
    become lists."""
    if isinstance(tree, torch.Tensor):
        return {"__array__": {"shape": list(tree.shape), "dtype": str(tree.dtype).removeprefix("torch.")}}
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_meta(v) for v in tree]
    return tree


def _from_meta(meta: Any) -> Any:
    if isinstance(meta, dict):
        if set(meta) == {"__array__"}:
            return ArrayMeta(tuple(meta["__array__"]["shape"]), getattr(torch, meta["__array__"]["dtype"]))
        return {k: _from_meta(v) for k, v in meta.items()}
    if isinstance(meta, list):
        return [_from_meta(v) for v in meta]
    return meta


def template_from_metadata(meta: Any) -> Any:
    """A zeros restore template with the stored shapes and dtypes, for a
    subtree whose live structure has drifted from the saved one (an SDF
    optimiser of another kind, say), so that the subtree can still be read
    and then discarded or rebuilt."""
    if isinstance(meta, ArrayMeta):
        return torch.zeros(meta.shape, dtype=meta.dtype)
    if isinstance(meta, dict):
        return {k: template_from_metadata(v) for k, v in meta.items()}
    if isinstance(meta, (list, tuple)):
        return [template_from_metadata(v) for v in meta]
    return meta


def _like(stored: Any, template: Any, path: str) -> Any:
    """`stored` in the template's structure: dataclasses rebuilt, tensors on
    the template's device. A different structure, shape or dtype raises
    ValueError naming the path."""
    def fail(why):
        raise ValueError(f"checkpoint does not fit the template at {path or '/'}: {why}")

    if isinstance(template, torch.Tensor):
        if not isinstance(stored, torch.Tensor):
            fail(f"stored {type(stored).__name__}, template a tensor")
        if stored.shape != template.shape or stored.dtype != template.dtype:
            fail(f"stored {tuple(stored.shape)} {stored.dtype}, template {tuple(template.shape)} {template.dtype}")
        return stored.to(template.device)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        names = [f.name for f in dataclasses.fields(template)]
        if not isinstance(stored, dict) or set(stored) != set(names):
            fail(f"stored {sorted(stored) if isinstance(stored, dict) else type(stored).__name__}, fields {names}")
        return type(template)(**{k: _like(stored[k], getattr(template, k), f"{path}/{k}") for k in names})
    if isinstance(template, dict):
        if not isinstance(stored, dict) or set(stored) != set(template):
            fail(f"stored keys {sorted(stored) if isinstance(stored, dict) else type(stored).__name__}, "
                 f"template keys {sorted(template)}")
        return {k: _like(stored[k], template[k], f"{path}/{k}") for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(stored, (list, tuple)) or len(stored) != len(template):
            fail(f"stored {type(stored).__name__}, template a sequence of {len(template)}")
        return type(template)(_like(s, t, f"{path}/{i}") for i, (s, t) in enumerate(zip(stored, template)))
    if template is None or stored is None:
        if stored is not template:
            fail(f"stored {type(stored).__name__}, template {type(template).__name__}")
        return None
    if isinstance(stored, (torch.Tensor, dict, list, tuple)):
        fail(f"stored {type(stored).__name__}, template a scalar")
    return stored


class CheckpointManager:
    """Steps saved under `directory`; with `save_only_latest` only the newest
    is kept. With a mesh only rank 0 writes."""

    def __init__(self, directory: Path, save_only_latest: bool = True, mesh: Optional[Mesh] = None):
        self.directory = Path(directory).absolute()
        self.mesh = mesh
        self.writes = mesh is None or mesh.is_main
        if self.writes:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.save_only_latest = save_only_latest

    def steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / _STATE).exists() and (p / _META).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        """Write step `step`. A step at or below the latest raises: a save
        that did not happen must not pass for one."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            raise RuntimeError(f"checkpoint save at step {step} refused: the directory's latest is {latest}")
        if self.writes:
            self._write(step, state)
        barrier(self.mesh)

    def _write(self, step: int, state: Any) -> None:
        tree = to_tree(state)
        tmp = self.directory / f"{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(tree, tmp / _STATE)
        (tmp / _META).write_text(json.dumps(_to_meta(tree)))
        tmp.rename(self.directory / str(step))
        if self.save_only_latest:
            for old in self.steps():
                if old != step:
                    shutil.rmtree(self.directory / str(old))

    def metadata_tree(self, step: Optional[int] = None) -> Optional[Any]:
        """The stored tree with each tensor as an ArrayMeta (shape, dtype),
        read without loading the state; None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return _from_meta(json.loads((self.directory / str(step) / _META).read_text()))

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """The stored state in the template's structure, on its devices."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        stored = torch.load(self.directory / str(step) / _STATE, weights_only=True)
        return _like(stored, state_template, "")
