"""Method registry: the named end-to-end training configurations (port of
nerf_emitter_tpu/configs/methods.py).

- nerfacto: the upstream LDR baseline;
- hdr-nerfacto: HDR pretraining for real scenes (2,000 steps, 2^15 rays);
- sdf-nerfacto: 2,000 pretraining steps, then 320 takeover steps; 2^14
  rays, rawnerf plus relative_l1, the x0.01 lr drop at the takeover, vMF
  guiding; the distilled emitter cache and the reduced emitter sample
  schedule as `configs/gates.json` decides;
- sdf-gt-envmap: the SDF alone under a known envmap (takeover at step 0,
  'env' guiding).

Methods that plugins register (plugins/registry.py) join the built-ins.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

from ..engine.train_loop import TrainConfig
from ..pipelines.nerf_emitter import NerfEmitterPipelineConfig
from .gates import gate_default


@dataclasses.dataclass
class ModelSettings:
    """The NerfactoModel settings that methods vary."""

    hdr: bool = True
    num_nerf_samples: int = 48
    num_proposal_samples: tuple = (256, 96)
    log2_hashmap_size: int = 19
    max_res: int = 2048
    appearance_embedding_dim: int = 32
    background_color: str = "last_sample"
    use_fake_contraction: bool = True
    implementation: str = "freq"  # 'freq' (the kernels' field) | 'hash'
    optimize_camera_poses: bool = False


@dataclasses.dataclass
class DataSettings:
    data: Path = Path(".")
    dataparser: str = "instant-ngp-data"  # or "nerfstudio-data"
    downscale_factor: int = 1
    scene_scale: float = 1.0 / 3.0
    aabb_scale: float = 1.5
    eval_mode: str = "fraction"
    mi_data: Optional[Path] = None
    test_data: Optional[Path] = None


@dataclasses.dataclass
class ExperimentConfig:
    method_name: str = "sdf-nerfacto"
    experiment_name: str = "default"
    output_dir: Path = Path("outputs")
    max_num_iterations: int = 2320
    steps_per_save: int = 500
    steps_per_eval_image: int = 500
    seed: int = 42
    viewer_port: int = 0  # the web viewer's port (viewer/server.py); 0: no viewer
    opt_config_name: str = "diffuse-12-relativel1-hqq"
    # the device the run lives on: CUDA unless the CPU is asked for
    device: str = "cuda"
    model: ModelSettings = dataclasses.field(default_factory=ModelSettings)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    pipeline: NerfEmitterPipelineConfig = dataclasses.field(default_factory=NerfEmitterPipelineConfig)
    datacfg: DataSettings = dataclasses.field(default_factory=DataSettings)

    @property
    def run_dir(self) -> Path:
        return Path(self.output_dir) / self.experiment_name / self.method_name


PRETRAIN_ITER = 2000
MI_OPT_ITER = 320


def _nerfacto() -> ExperimentConfig:
    return ExperimentConfig(
        method_name="nerfacto",
        max_num_iterations=30000,
        model=ModelSettings(hdr=False, use_fake_contraction=False),
        train=TrainConfig(num_rays_per_batch=4096, rgb_loss="mse", rgb_loss_second=None, max_steps=30000),
        pipeline=NerfEmitterPipelineConfig(takeover_step=1 << 30),
    )


def _hdr_nerfacto() -> ExperimentConfig:
    return ExperimentConfig(
        method_name="hdr-nerfacto",
        max_num_iterations=PRETRAIN_ITER,
        model=ModelSettings(hdr=True),
        train=TrainConfig(num_rays_per_batch=1 << 15, rgb_loss="rawnerf", rgb_loss_second="relative_l1",
                          max_steps=PRETRAIN_ITER, anneal_steps=1000, lr_fields=1e-3, lr_proposal=1e-3),
        pipeline=NerfEmitterPipelineConfig(takeover_step=1 << 30),
    )


def _sdf_nerfacto() -> ExperimentConfig:
    return ExperimentConfig(
        method_name="sdf-nerfacto",
        max_num_iterations=PRETRAIN_ITER + MI_OPT_ITER,
        model=ModelSettings(hdr=True),
        train=TrainConfig(num_rays_per_batch=1 << 14, rgb_loss="rawnerf", rgb_loss_second="relative_l1",
                          max_steps=PRETRAIN_ITER + MI_OPT_ITER, anneal_steps=1000, step_pretrain=PRETRAIN_ITER,
                          lr_fields=1e-3, lr_proposal=1e-3),
        pipeline=NerfEmitterPipelineConfig(
            takeover_step=PRETRAIN_ITER,
            mi_opt_steps=MI_OPT_ITER,
            guiding_type="vmf",
            # the performance levers' defaults, decided by the quality gates
            distill_emitter=gate_default("distill_emitter"),
            emitter_samples=(128, 48, 24) if gate_default("emitter_samples_reduced") else None,
        ),
    )


def _sdf_gt_envmap() -> ExperimentConfig:
    return ExperimentConfig(
        method_name="sdf-gt-envmap",
        max_num_iterations=MI_OPT_ITER,
        model=ModelSettings(hdr=True),
        train=TrainConfig(max_steps=MI_OPT_ITER),
        pipeline=NerfEmitterPipelineConfig(
            takeover_step=0,
            mi_opt_steps=MI_OPT_ITER,
            guiding_type="env",
            # an envmap is cheap to evaluate: deterministic MIS
            mis_mode="both",
        ),
    )


METHOD_CONFIGS = {
    "nerfacto": _nerfacto,
    "hdr-nerfacto": _hdr_nerfacto,
    "sdf-nerfacto": _sdf_nerfacto,
    "sdf-gt-envmap": _sdf_gt_envmap,
}

METHOD_DESCRIPTIONS = {
    "nerfacto": "LDR nerfacto baseline (upstream parity)",
    "hdr-nerfacto": "HDR radiance-field pretraining for real captures",
    "sdf-nerfacto": "NeRF-as-emitter inverse rendering (the flagship)",
    "sdf-gt-envmap": "SDF inverse rendering under a known GT envmap",
}


def all_method_configs():
    """(name -> config factory, name -> description): the plugin-registered
    methods (plugins/registry.py) and the built-ins, which win on a name
    clash, so a plugin cannot shadow sdf-nerfacto."""
    from ..plugins.registry import discover_methods

    methods, descriptions = discover_methods()
    methods.update(METHOD_CONFIGS)
    descriptions.update(METHOD_DESCRIPTIONS)
    return methods, descriptions


def get_method_config(name: str) -> ExperimentConfig:
    methods, _ = all_method_configs()
    if name not in methods:
        raise KeyError(f"unknown method {name!r}; have {sorted(methods)}")
    return methods[name]()
