"""Dataclass -> argparse CLI bridge (port of nerf_emitter_tpu/configs/cli.py).

Nested dataclasses map to --dotted.flag-names; the resolved config
serialises to JSON (dataclasses by their qualified names, which are this
package's) and loads back.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import typing
from enum import Enum
from pathlib import Path
from typing import Any, Union, get_args, get_origin


def _is_optional(t):
    return get_origin(t) is Union and type(None) in get_args(t)


def _unwrap_optional(t):
    args = [a for a in get_args(t) if a is not type(None)]
    return args[0] if args else str


def _is_tuple(t) -> bool:
    return get_origin(t) is tuple or t is tuple


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = "") -> None:
    """One flag per leaf field of `cls`, nested dataclasses prefixed by
    their field name: bools take 1/true/yes, tuples and lists JSON, Enums
    a member name."""
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        name = f"{prefix}{f.name}"
        t = hints.get(f.name, str)
        if _is_optional(t):
            t = _unwrap_optional(t)
        if dataclasses.is_dataclass(t):
            add_dataclass_args(parser, t, prefix=f"{name}.")
            continue
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
        flag = "--" + name.replace("_", "-")
        if t is bool:
            parser.add_argument(flag, type=_parse_bool, default=default, metavar="BOOL")
        elif t in (int, float, str, Path):
            parser.add_argument(flag, type=t, default=default)
        elif isinstance(t, type) and issubclass(t, Enum):
            parser.add_argument(flag, type=lambda s, tt=t: tt[s.upper()], default=default)
        elif get_origin(t) in (tuple, list) or t in (tuple, list):
            parser.add_argument(flag, type=json.loads, default=default, metavar="JSON")
        else:
            parser.add_argument(flag, type=str, default=default)


def dataclass_from_args(cls, args: argparse.Namespace, prefix: str = ""):
    """`cls` built from the parsed flags that add_dataclass_args made."""
    kwargs: dict[str, Any] = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        name = f"{prefix}{f.name}"
        t = hints.get(f.name, str)
        if _is_optional(t):
            t = _unwrap_optional(t)
        if dataclasses.is_dataclass(t):
            kwargs[f.name] = dataclass_from_args(t, args, prefix=f"{name}.")
            continue
        val = getattr(args, name)
        if val is not None and _is_tuple(t) and isinstance(val, list):
            val = tuple(tuple(v) if isinstance(v, list) else v for v in val)
        kwargs[f.name] = val
    return cls(**kwargs)


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dataclass__": f"{type(obj).__module__}.{type(obj).__qualname__}",
                **{f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    if isinstance(obj, Path):
        return {"__path__": str(obj)}
    if isinstance(obj, Enum):
        return {"__enum__": f"{type(obj).__module__}.{type(obj).__qualname__}", "name": obj.name}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


def _resolve(qualname: str):
    """A class of this package by its qualified name; any other module
    raises, so a config file cannot import arbitrary code."""
    mod, _, name = qualname.rpartition(".")
    package = __name__.split(".")[0]
    if mod.split(".")[0] != package:
        raise ValueError(f"{qualname!r} is not a class of {package}")
    target = importlib.import_module(mod)
    for part in name.split("."):
        target = getattr(target, part)
    return target


def _from_jsonable(obj):
    if isinstance(obj, dict):
        if "__dataclass__" in obj:
            cls = _resolve(obj["__dataclass__"])
            fields = {k: _from_jsonable(v) for k, v in obj.items() if k != "__dataclass__"}
            for k, t in typing.get_type_hints(cls).items():
                if _is_optional(t):
                    t = _unwrap_optional(t)
                if k in fields and _is_tuple(t) and isinstance(fields[k], list):
                    fields[k] = tuple(tuple(x) if isinstance(x, list) else x for x in fields[k])
            return cls(**fields)
        if "__path__" in obj:
            return Path(obj["__path__"])
        if "__enum__" in obj:
            return _resolve(obj["__enum__"])[obj["name"]]
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(x) for x in obj]
    return obj


def save_config(config, path: Path) -> None:
    """Write the resolved config as JSON."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_to_jsonable(config), f, indent=2)


def load_config(path: Path):
    with open(path) as f:
        return _from_jsonable(json.load(f))
