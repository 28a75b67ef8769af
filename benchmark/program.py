"""The system under test: the port's objects built from a configuration
and a traffic mix. This is the only module of the benchmark that imports
the port (`nerf_emitter_tpu_torch`), and it does so when called."""

from __future__ import annotations

import contextlib
import dataclasses

import torch

# switches the port reads from the environment; the benchmark runs its
# defaults (K5, the default grad-band budget)
PORT_ENV = ("NERF_EMITTER_MEGA_PIPELINED", "NERF_EMITTER_MEGA_MXU_CHUNK", "NERF_EMITTER_GRAD_BAND_BUDGET")


def build_model(config: dict, num_cameras: int, weights: dict, device):
    """The port's NerfactoModel with the benchmark's weights; raises
    ValueError where its widths differ from the configuration's."""
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel

    from .drivers.common import check_model, model_kwargs

    kw = model_kwargs(config, num_cameras)
    model = NerfactoModel(kw.pop("aabb"), device=device, **kw)
    check_model(model, config)
    load_weights(model, weights)
    return model


@torch.no_grad()
def load_weights(model, weights: dict) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights) or any(params[k].shape != weights[k].shape for k in params):
        raise ValueError(f"the program's parameters differ from the configuration's: "
                         f"{sorted(set(params) ^ set(weights))}")
    for k, p in params.items():
        p.copy_(weights[k])


def build_dataset(cams: dict, images, masks=None):
    from nerf_emitter_tpu_torch.cameras.cameras import Cameras
    from nerf_emitter_tpu_torch.data.datamanager import ImageDataset

    return ImageDataset(cameras=Cameras(**cams), images=images, masks=masks, is_hdr=True)


def build_pipeline(config: dict, model, dataset):
    """The port's NerfEmitterPipeline for the configuration."""
    from nerf_emitter_tpu_torch.engine.train_loop import TrainConfig
    from nerf_emitter_tpu_torch.pipelines.nerf_emitter import NerfEmitterPipeline, NerfEmitterPipelineConfig
    from nerf_emitter_tpu_torch.renderer.optimize import get_opt_config

    t = config["train"]
    train = TrainConfig(num_rays_per_batch=t["num_rays_per_batch"], rgb_loss=t["rgb_loss"],
                        rgb_loss_second=t["rgb_loss_second"], max_steps=t["max_steps"],
                        anneal_steps=t["anneal_steps"], step_pretrain=t["step_pretrain"], lr_fields=t["lr_fields"],
                        lr_proposal=t["lr_proposal"])
    p = config["pipeline"]
    pipe = NerfEmitterPipelineConfig(
        takeover_step=p["takeover_step"], mi_opt_steps=p["mi_opt_steps"], guiding_type=p["guiding_type"],
        proposal_rebuild_every=p["proposal_rebuild_every"], distill_emitter=p["distill_emitter"],
        distill_steps=p["distill_steps"],
        emitter_samples=None if p["emitter_samples"] is None else tuple(p["emitter_samples"]),
        sdf_init=p["sdf_init"], batch_size=p["batch_size"], spp=p["spp"], spp_attached=p["spp_attached"],
        takeover_image_size=p["takeover_image_size"], object_aabb=tuple(map(tuple, p["object_aabb"])),
        scene_scale=p["scene_scale"])
    return NerfEmitterPipeline(pipe, model, train, get_opt_config(p["opt_config_name"]), dataset)


@contextlib.contextmanager
def port_tracing(on: bool = True):
    """The port's tracing (`utils/profiler`) reset and, where `on`, switched
    on over the block; yields a dict that holds the port's counters once
    the block has closed (empty with the tracing off). The tracing is off
    and reset after the block."""
    from nerf_emitter_tpu_torch.utils import profiler

    profiler.reset()
    profiler.enable(on)
    counts = {}
    try:
        yield counts
    finally:
        profiler.disable()
        counts.update(profiler.counters())
        profiler.reset()


def kernel_launches() -> dict:
    """The port's launch counter (kernels.launches), by kernel."""
    from nerf_emitter_tpu_torch import kernels

    return dict(kernels.launches)


def replace_step(pipeline, step: int) -> None:
    """Put the takeover's step counter at `step`."""
    pipeline.sdf_state = dataclasses.replace(pipeline.sdf_state, step=step)
