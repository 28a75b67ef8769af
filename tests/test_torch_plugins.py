"""The port's plugin registry: tests/test_plugins.py's seven cases on the
port's own entry-point groups and environment variables (the specs are
defined here and build the port's ExperimentConfig), and the JAX package's
variables, which the port ignores."""

import dataclasses
import sys
import warnings

import pytest
import torch

from nerf_emitter_tpu.plugins import registry as jregistry
from nerf_emitter_tpu_torch.configs.methods import ExperimentConfig, all_method_configs, get_method_config
from nerf_emitter_tpu_torch.plugins import DataParserSpecification, MethodSpecification
from nerf_emitter_tpu_torch.plugins.registry import (DATAPARSER_ENTRY_POINT_GROUP, DATAPARSER_ENV_VAR,
                                                     METHOD_ENTRY_POINT_GROUP, METHOD_ENV_VAR, discover_dataparsers,
                                                     discover_methods)

torch.set_num_threads(1)

method_spec = MethodSpecification(config=ExperimentConfig(method_name="plugin-nerfacto", seed=1234),
                                  description="fixture method registered by tests")


def _factory():
    return ExperimentConfig(method_name="plugin-factory", seed=99)


factory_spec = MethodSpecification(config=_factory, description="fixture factory method")
# a spec that tries to shadow a built-in method name; built-ins must win
shadow_spec = MethodSpecification(config=ExperimentConfig(method_name="sdf-nerfacto", seed=-1),
                                  description="attempted shadow of a built-in")


@dataclasses.dataclass
class _ToyOutputs:
    split: str
    datacfg: object


def _toy_setup(datacfg):
    def parse(split):
        return _ToyOutputs(split=split, datacfg=datacfg)

    return parse


dataparser_spec = DataParserSpecification(name="toy-data", setup=_toy_setup, description="fixture dataparser")
not_a_spec = object()
HERE = __name__  # this module, importable by name from the environment variables


def test_discover_methods_from_env(monkeypatch):
    monkeypatch.setenv(METHOD_ENV_VAR, f"plugin-nerfacto={HERE}:method_spec,plugin-factory={HERE}:factory_spec")
    methods, descriptions = discover_methods()
    assert set(methods) >= {"plugin-nerfacto", "plugin-factory"}
    cfg = methods["plugin-nerfacto"]()
    assert isinstance(cfg, ExperimentConfig)
    assert cfg.method_name == "plugin-nerfacto" and cfg.seed == 1234
    # factory-style specs are called fresh each time
    a, b = methods["plugin-factory"](), methods["plugin-factory"]()
    assert a is not b and a.seed == 99
    assert descriptions["plugin-nerfacto"] == "fixture method registered by tests"


def test_builtins_win_over_plugin_shadow(monkeypatch):
    monkeypatch.setenv(METHOD_ENV_VAR, f"shadow={HERE}:shadow_spec")
    methods, _ = all_method_configs()
    assert methods["sdf-nerfacto"]().seed != -1  # the built-in config, not the shadow


def test_bad_definitions_fail_soft(monkeypatch):
    monkeypatch.setenv(METHOD_ENV_VAR, f"broken=missing_module:spec,notaspec={HERE}:not_a_spec,"
                                       f"good={HERE}:method_spec")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        methods, _ = discover_methods()
    assert "plugin-nerfacto" in methods
    assert "broken" not in methods and "notaspec" not in methods
    assert len(w) >= 2  # one warning per bad definition


def test_train_cli_picks_up_plugin_method(monkeypatch, tmp_path):
    monkeypatch.setenv(METHOD_ENV_VAR, f"plugin-nerfacto={HERE}:method_spec")
    from nerf_emitter_tpu_torch.scripts.train import build_parser

    args = build_parser().parse_args(["plugin-nerfacto", "--datacfg.data", str(tmp_path)])
    assert args.method == "plugin-nerfacto"
    assert args.seed == 1234  # the plugin's defaults flow into the parser


def test_discover_dataparsers_from_env(monkeypatch):
    monkeypatch.setenv(DATAPARSER_ENV_VAR, f"toy-data={HERE}:dataparser_spec")
    parsers = discover_dataparsers()
    assert "toy-data" in parsers
    out = parsers["toy-data"].setup({"marker": True})("train")
    assert out.split == "train" and out.datacfg == {"marker": True}


def test_no_env_is_empty(monkeypatch):
    monkeypatch.delenv(METHOD_ENV_VAR, raising=False)
    monkeypatch.delenv(DATAPARSER_ENV_VAR, raising=False)
    methods, _ = discover_methods()
    assert methods == {} or all(not n.startswith("plugin-") for n in methods)
    assert "toy-data" not in discover_dataparsers()


def test_get_method_config_unknown_raises(monkeypatch):
    monkeypatch.delenv(METHOD_ENV_VAR, raising=False)
    with pytest.raises(KeyError):
        get_method_config("definitely-not-a-method")


def test_jax_packages_registrations_are_ignored(monkeypatch):
    """A plugin registered for the JAX package (its variables, its groups)
    builds that package's config: the port neither reads nor imports it."""
    assert (METHOD_ENV_VAR, DATAPARSER_ENV_VAR) != (jregistry.METHOD_ENV_VAR, jregistry.DATAPARSER_ENV_VAR)
    assert {METHOD_ENTRY_POINT_GROUP, DATAPARSER_ENTRY_POINT_GROUP}.isdisjoint(
        {jregistry.METHOD_ENTRY_POINT_GROUP, jregistry.DATAPARSER_ENTRY_POINT_GROUP})
    monkeypatch.delenv(METHOD_ENV_VAR, raising=False)
    monkeypatch.delenv(DATAPARSER_ENV_VAR, raising=False)
    monkeypatch.setenv(jregistry.METHOD_ENV_VAR, "jax-only=plugin_fixture:method_spec")
    monkeypatch.setenv(jregistry.DATAPARSER_ENV_VAR, "toy-data=plugin_fixture:dataparser_spec")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        methods, _ = discover_methods()
        parsers = discover_dataparsers()
    assert "plugin-nerfacto" not in methods and "toy-data" not in parsers
    assert "plugin-nerfacto" in jregistry.discover_methods()[0]  # what the JAX package would see


def test_trainer_parses_with_a_plugin_dataparser(monkeypatch, tmp_path):
    """The trainer picks a plugin dataparser by name before the built-in
    ones; an unknown name raises and lists what there is."""
    from nerf_emitter_tpu_torch.engine.trainer import Trainer

    seen = []

    def setup(datacfg):
        def parse(split):
            seen.append((split, datacfg.dataparser))
            raise ValueError("no images")  # stops setup after the call

        return parse

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # its import pulls in TensorFlow where present
    monkeypatch.setattr(sys.modules[HERE], "probe_spec", DataParserSpecification(name="probe-data", setup=setup),
                        raising=False)
    monkeypatch.setenv(DATAPARSER_ENV_VAR, f"probe-data={HERE}:probe_spec")
    cfg = ExperimentConfig(output_dir=tmp_path, device="cpu")
    cfg.datacfg.dataparser = "probe-data"
    with pytest.raises(ValueError, match="no images"):
        Trainer(cfg).setup()
    assert seen == [("train", "probe-data")]
    cfg.datacfg.dataparser = "no-such-data"
    with pytest.raises(ValueError, match="unknown dataparser"):
        Trainer(cfg).setup()
