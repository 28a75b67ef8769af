"""Specification types used to register external plugins (port of
nerf_emitter_tpu/plugins/types.py).

Re-design of nerfstudio/plugins/types.py (MethodSpecification wrapping a
TrainerConfig) for this framework's registry shape: methods are factory
functions returning ExperimentConfig (configs/methods.py METHOD_CONFIGS),
and dataparsers are (config dataclass, parse function) pairs selected by
name in engine/trainer.py. A spec registered with the port builds the port's
ExperimentConfig (nerf_emitter_tpu_torch/configs/methods.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class MethodSpecification:
    """Registers a training method with the `train` CLI.

    `config` is either an ExperimentConfig instance or a zero-arg factory
    returning one (matching METHOD_CONFIGS entries). The method name used
    on the CLI comes from `config.method_name`.

    Reference: nerfstudio/plugins/types.py:24-33 (MethodSpecification).
    """

    config: object  # ExperimentConfig | Callable[[], ExperimentConfig]
    description: str = ""

    def factory(self) -> Callable[[], object]:
        cfg = self.config
        if callable(cfg) and not dataclasses.is_dataclass(cfg):
            return cfg
        return lambda: dataclasses.replace(cfg)

    @property
    def method_name(self) -> str:
        cfg = self.config
        if callable(cfg) and not dataclasses.is_dataclass(cfg):
            cfg = cfg()
        return cfg.method_name


@dataclasses.dataclass
class DataParserSpecification:
    """Registers a dataparser selectable via `--datacfg.dataparser <name>`.

    `setup(datacfg)` receives the run's DataSettings and returns a
    `parse(split: str) -> DataparserOutputs` callable, mirroring how the
    built-in instant-ngp / nerfstudio parsers are driven by the trainer.

    Reference: nerfstudio/plugins/registry_dataparser.py:28-37
    (DataParserSpecification wrapping a DataParserConfig).
    """

    name: str
    setup: Callable[[object], Callable[[str], object]]
    description: str = ""
