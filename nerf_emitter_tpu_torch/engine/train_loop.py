"""NeRF pretraining: the train step, the eval renderer and the image
metrics (port of nerf_emitter_tpu/engine/train_loop.py).

A step draws a pixel batch on the device, jitters the rays inside their
pixels, runs the training forward with the annealed proposal weights,
sums the photometric, interlevel and distortion losses, backpropagates and
steps each parameter group's Adam. The reference's step is one jitted XLA
program with no Pallas kernel; this one is plain PyTorch.

Across ranks (`mesh`, parallel/mesh.py): every rank draws the whole pixel
batch, its jitter and the model's stratified draws from the same
generator and keeps its rows; the forward's per-ray outputs are gathered
back to the batch, so the loss is the batch's mean on every rank; the
gradients are summed over the ranks before each group's Adam. The eval
renderer splits each chunk of pixels over the ranks the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..cameras.cameras import Cameras
from ..cameras.rays import RayBundle
from ..data.datamanager import ImageDataset, generate_train_rays, sample_pixel_batch
from ..fields.mlp import MLP, round_to_bf16_
from ..models.nerfacto import NerfactoModel
from ..ops import losses as L
from ..parallel.mesh import Mesh, all_reduce_grads, data_sharded, gather_rows, replicated, row_generator
from ..utils import profiler
from ..utils.math import linear_to_srgb, mape, psnr, ssim
from ..utils.perceptual import lpips
from .optimizers import MultiOptimizer, OptimizerGroupConfig, build_optimizer
from .schedulers import proposal_anneal_schedule


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The nerfacto training phase (the reference's hdr-nerfacto and
    sdf-nerfacto pretraining)."""

    num_rays_per_batch: int = 4096
    near: float = 0.05
    far: float = 1e3
    rgb_loss: str = "rawnerf"
    rgb_loss_second: Optional[str] = "relative_l1"  # averaged with rgb_loss
    interlevel_mult: float = 1.0
    distortion_mult: float = 0.002
    anneal_steps: int = 1000
    anneal_slope: float = 10.0
    masked_sampling: bool = False
    rotation_radius: float = 0.6  # the turntable sphere
    max_steps: int = 2000
    lr_fields: float = 1e-2
    lr_proposal: float = 1e-2
    lr_final_ratio: float = 0.1
    step_pretrain: Optional[int] = None  # LR x0.01 drop at the takeover
    data_axis: Optional[str] = None  # the mesh axis the rays shard over (parallel.mesh.DATA_AXIS)


@dataclasses.dataclass
class TrainState:
    """The step count. The parameters live in the model and the Adam
    moments and schedules in the optimizer, the two objects the train step
    is built on."""

    step: int


def train_state_tree(state: TrainState, model: NerfactoModel, optimizer: MultiOptimizer) -> dict:
    """The NeRF's whole train state as a tree (what a checkpoint stores):
    the step, the parameters by name and each group's Adam moments and
    schedule step (MultiOptimizer.state_tree)."""
    return {"step": state.step, "params": {n: p.detach() for n, p in model.named_parameters()},
            "opt_state": optimizer.state_tree()}


@torch.no_grad()
def load_train_state_tree(tree: dict, model: NerfactoModel, optimizer: MultiOptimizer) -> TrainState:
    """Copy a train_state_tree into the model and the optimizer; returns
    the TrainState."""
    params = dict(model.named_parameters())
    if set(tree["params"]) != set(params):
        raise KeyError(f"parameter names differ: {sorted(set(tree['params']) ^ set(params))}")
    for name, p in params.items():
        p.copy_(tree["params"][name])
    optimizer.load_state_tree(tree["opt_state"])
    return TrainState(step=int(tree["step"]))


def build_nerfacto_optimizer(config: TrainConfig, model: NerfactoModel) -> MultiOptimizer:
    groups = {
        "fields": OptimizerGroupConfig(
            lr=config.lr_fields, lr_final=config.lr_fields * config.lr_final_ratio,
            max_steps=config.max_steps, step_pretrain=config.step_pretrain, lr_lambda=0.01,
        ),
        "proposal_networks": OptimizerGroupConfig(
            lr=config.lr_proposal, lr_final=config.lr_proposal * config.lr_final_ratio,
            max_steps=config.max_steps, step_pretrain=config.step_pretrain, lr_lambda=0.01,
        ),
        "camera_opt": OptimizerGroupConfig(lr=1e-3, max_steps=config.max_steps),
    }
    return build_optimizer(groups, model.named_parameters())


def create_train_state(model: NerfactoModel, config: TrainConfig,
                       mesh: Optional[Mesh] = None) -> tuple[TrainState, MultiOptimizer]:
    """The model is initialised where it is built; this adds its
    optimizers. Returns (state, optimizer), as the reference's (state, tx).
    With a mesh every rank starts from rank 0's weights."""
    replicated(model, mesh)
    return TrainState(step=0), build_nerfacto_optimizer(config, model)


def _ray_rows(rays: RayBundle, mesh: Mesh) -> RayBundle:
    """This rank's rows of every per-ray field."""
    return RayBundle(**{f.name: None if getattr(rays, f.name) is None else data_sharded(getattr(rays, f.name), mesh)
                        for f in dataclasses.fields(rays)})


def nerfacto_loss(
    model: NerfactoModel,
    config: TrainConfig,
    rays: RayBundle,
    gt: torch.Tensor,
    mask: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    proposal_anneal: float = 1.0,
    rotater=None,
    camera_rot_ids: Optional[torch.Tensor] = None,
    mesh: Optional[Mesh] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The step's loss on given rays and targets (n, 3): the mean of the
    photometric losses, plus the weighted interlevel and distortion
    losses. Returns (total, metrics), the metrics detached. With a mesh
    each rank runs the forward on its rows of the rays (and of the
    generator's draws) and the per-ray outputs are gathered, so every rank
    holds the batch's loss and its backward reaches its own rows."""
    n = gt.shape[0]
    sharded = mesh is not None and mesh.world_size > 1
    if sharded:
        rays, generator = _ray_rows(rays, mesh), row_generator(generator, mesh, n)
    out = model(rays, generator=generator, train=True, proposal_anneal=proposal_anneal, rotater=rotater,
                camera_rot_ids=camera_rot_ids if rotater is not None else None,
                rotation_radius=config.rotation_radius)
    if sharded:
        rs = out["ray_samples"]
        out = {"rgb": gather_rows(out["rgb"], mesh, n),
               "weights_list": [gather_rows(w, mesh, n) for w in out["weights_list"]],
               "spacing_bins_list": [gather_rows(b, mesh, n) for b in out["spacing_bins_list"]],
               "ray_samples": dataclasses.replace(rs, spacing_starts=gather_rows(rs.spacing_starts, mesh, n),
                                                  spacing_ends=gather_rows(rs.spacing_ends, mesh, n))}
    rgb_fns = [L.RGB_LOSSES[config.rgb_loss]]
    if config.rgb_loss_second is not None:
        rgb_fns.append(L.RGB_LOSSES[config.rgb_loss_second])
    pred = out["rgb"]
    pred_m, gt_m = (pred * mask, gt * mask) if config.masked_sampling else (pred, gt)
    rgb_loss = sum(f(pred_m, gt_m) for f in rgb_fns) / len(rgb_fns)
    il = L.interlevel_loss(out["weights_list"], out["spacing_bins_list"])
    rs = out["ray_samples"]
    dl = L.distortion_loss(out["weights_list"][-1], rs.spacing_starts, rs.spacing_ends)
    total = rgb_loss + config.interlevel_mult * il + config.distortion_mult * dl
    metrics = {"loss": total, "rgb_loss": rgb_loss, "interlevel": il, "distortion": dl,
               "psnr_linear": psnr(pred, gt, max_val=1.0)}
    return total, {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: NerfactoModel, config: TrainConfig, optimizer: MultiOptimizer, mesh: Optional[Mesh] = None,
                    rotater=None):
    """Returns train_step(state, dataset, generator) -> metrics: one step on
    a fresh pixel batch, which advances state.step. `generator` lives on
    the dataset's device and draws the pixels, their jitter, the
    stratified samples and any random background. The metrics are 0-d
    device tensors (reading them waits for the step).

    mesh: with config.data_axis set, the pixel batch is split over the
    ranks (each draws the whole batch and keeps its rows), the loss is the
    batch's mean and the gradients are summed over the ranks before Adam;
    the step then equals the one-rank step.

    rotater: a fields.rotater.Rotater for turntable captures; with the
    dataset's rotation_ids, samples near the object are mapped to the
    canonical object frame per image."""
    mesh = mesh if config.data_axis is not None and mesh is not None and mesh.world_size > 1 else None
    params = [p for p in model.parameters() if p.requires_grad]
    bf16_params = []  # the MLPs' weights and biases: their summed gradients are rounded to bf16 once
    if mesh is not None:
        for m in model.modules():
            if isinstance(m, MLP):
                m.defer_grad_rounding = True
                bf16_params += [p for lin in m.layers() for p in (lin.weight, lin.bias) if p.requires_grad]
    anneal_fn = proposal_anneal_schedule(config.anneal_steps, config.anneal_slope)

    @profiler.span("nerf.step")
    def train_step(state: TrainState, dataset: ImageDataset, generator: torch.Generator) -> dict:
        with profiler.span("nerf.batch"):
            cam, coords, gt, mask = sample_pixel_batch(generator, dataset.images, config.num_rays_per_batch,
                                                       masks=dataset.masks, masked_sampling=config.masked_sampling)
            rays = generate_train_rays(dataset.cameras, cam, coords, generator, near=config.near, far=config.far)
        # a step trains whatever the caller's grad mode
        with torch.enable_grad(), profiler.span("nerf.forward_backward"):
            total, metrics = nerfacto_loss(
                model, config, rays, gt, mask, generator=generator, proposal_anneal=anneal_fn(state.step),
                rotater=rotater, camera_rot_ids=dataset.rotation_ids, mesh=mesh,
            )
            optimizer.zero_grad()
            total.backward()
        with profiler.span("nerf.optimizer"):
            all_reduce_grads(params, mesh)
            round_to_bf16_([p.grad for p in bf16_params if p.grad is not None])
            optimizer.step()
        state.step += 1
        return metrics

    return train_step


def make_render_fn(model: NerfactoModel, config: TrainConfig, chunk: int = 4096, rotater=None,
                   camera_rot_ids: Optional[torch.Tensor] = None, mesh: Optional[Mesh] = None,
                   data_axis: Optional[str] = None):
    """Full-image eval renderer over fixed-size ray chunks, without
    gradients. Returns render_image(cameras, cam_index, height, width,
    aabb_box=None) -> {'rgb' (H, W, 3), 'depth' (H, W, 1),
    'accumulation' (H, W, 1)}. With a mesh and data_axis the chunk grows by
    the world size, each rank renders its rows of a chunk and the rows are
    gathered, so every rank returns the whole image."""
    if mesh is None or data_axis is None:
        mesh = None
    else:
        chunk *= mesh.world_size

    @torch.no_grad()
    def render_image(cameras: Cameras, cam_index: int, height: int, width: int, aabb_box=None) -> dict:
        dev = cameras.camera_to_worlds.device
        yy, xx = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij")
        coords = torch.stack([yy, xx], dim=-1).reshape(-1, 2)
        cam_idx = torch.full((coords.shape[0],), int(cam_index), dtype=torch.long, device=dev)
        parts = {"rgb": [], "depth": [], "accumulation": []}
        for i in range(0, coords.shape[0], chunk):
            rays = cameras.generate_rays(cam_idx[i:i + chunk], coords[i:i + chunk], nears=config.near,
                                         fars=config.far, aabb_box=aabb_box)
            n = rays.origins.shape[0]
            if mesh is not None:
                rays = _ray_rows(rays, mesh)
            out = model(rays, train=False, use_average_appearance=False, rotater=rotater,
                        camera_rot_ids=camera_rot_ids, rotation_radius=config.rotation_radius)
            for k in parts:
                parts[k].append(gather_rows(out[k], mesh, n))
        return {k: torch.cat(v).reshape(height, width, -1) for k, v in parts.items()}

    return render_image


def eval_image_metrics(pred: torch.Tensor, gt: torch.Tensor, is_hdr: bool = True) -> dict[str, float]:
    """PSNR, SSIM, MAPE and the perceptual distance of one (H, W, 3)
    image. HDR images are sRGB-tonemapped for PSNR, SSIM and the
    perceptual distance; MAPE reads the linear values."""
    pred_t, gt_t = (linear_to_srgb(pred), linear_to_srgb(gt)) if is_hdr else (pred, gt)
    perceptual, perceptual_name = lpips(pred_t, gt_t)
    return {"psnr": float(psnr(pred_t, gt_t)), "ssim": float(ssim(pred_t, gt_t)),
            "mape": float(mape(pred, gt)), perceptual_name: float(perceptual)}
