"""Plugin discovery: external methods and dataparsers (port of
nerf_emitter_tpu/plugins/registry.py).

Re-design of nerfstudio/plugins/registry.py:34-71 and
registry_dataparser.py:40-61. Two discovery channels, same precedence as
the reference (entry points first, then the environment variable so local
overrides win):

- Python entry points, groups ``nerf_emitter_tpu_torch.method_configs`` and
  ``nerf_emitter_tpu_torch.dataparser_configs`` — any installed distribution
  can register specs.
- Environment variables ``NERF_EMITTER_TPU_TORCH_METHOD_CONFIGS`` /
  ``NERF_EMITTER_TPU_TORCH_DATAPARSER_CONFIGS`` with the reference's
  ``name=module:attr[,name=module:attr...]`` format — zero-install
  registration for local development.

The port reads only its own groups and variables: a plugin registered with
the JAX package builds that package's ExperimentConfig, which the port
never imports.

Discovery is fail-soft: a broken plugin prints a warning and is skipped,
never taking the CLI down (reference behavior, registry.py:44-48,64-68).
"""

from __future__ import annotations

import importlib
import os
import warnings
from typing import Callable, Dict, Tuple

from .types import DataParserSpecification, MethodSpecification

METHOD_ENTRY_POINT_GROUP = "nerf_emitter_tpu_torch.method_configs"
DATAPARSER_ENTRY_POINT_GROUP = "nerf_emitter_tpu_torch.dataparser_configs"
METHOD_ENV_VAR = "NERF_EMITTER_TPU_TORCH_METHOD_CONFIGS"
DATAPARSER_ENV_VAR = "NERF_EMITTER_TPU_TORCH_DATAPARSER_CONFIGS"


def _entry_points(group: str):
    from importlib.metadata import entry_points

    return entry_points(group=group)


def _load_env_specs(env_var: str):
    """Yield (name, loaded object) pairs from a `name=module:attr` list."""
    raw = os.environ.get(env_var, "")
    for definition in raw.split(","):
        definition = definition.strip()
        if not definition:
            continue
        try:
            name, path = definition.split("=", 1)
            module, attr = path.split(":", 1)
            yield name, getattr(importlib.import_module(module), attr)
        except Exception as e:  # fail-soft like the reference
            warnings.warn(
                f"could not load plugin {definition!r} from {env_var}: {e}"
            )


def discover_methods() -> Tuple[Dict[str, Callable[[], object]], Dict[str, str]]:
    """All externally-registered methods: (name -> config factory, name -> desc).

    Mirrors nerfstudio/plugins/registry.py:34-71 (discover_methods).
    """
    methods: Dict[str, Callable[[], object]] = {}
    descriptions: Dict[str, str] = {}

    def take(name_hint, spec):
        if not isinstance(spec, MethodSpecification):
            warnings.warn(
                f"plugin {name_hint!r} is not a MethodSpecification; skipped"
            )
            return
        name = spec.method_name
        methods[name] = spec.factory()
        descriptions[name] = spec.description

    for ep in _entry_points(METHOD_ENTRY_POINT_GROUP):
        try:
            take(ep.name, ep.load())
        except Exception as e:
            warnings.warn(f"could not load method entry point {ep.name!r}: {e}")
    for name, obj in _load_env_specs(METHOD_ENV_VAR):
        take(name, obj)
    return methods, descriptions


def discover_dataparsers() -> Dict[str, DataParserSpecification]:
    """All externally-registered dataparsers, keyed by CLI name.

    Mirrors nerfstudio/plugins/registry_dataparser.py:40-61.
    """
    parsers: Dict[str, DataParserSpecification] = {}

    def take(name_hint, spec):
        if not isinstance(spec, DataParserSpecification):
            warnings.warn(
                f"plugin {name_hint!r} is not a DataParserSpecification; skipped"
            )
            return
        parsers[spec.name] = spec

    for ep in _entry_points(DATAPARSER_ENTRY_POINT_GROUP):
        try:
            take(ep.name, ep.load())
        except Exception as e:
            warnings.warn(
                f"could not load dataparser entry point {ep.name!r}: {e}"
            )
    for name, obj in _load_env_specs(DATAPARSER_ENV_VAR):
        take(name, obj)
    return parsers
