"""The reference's drivers, in plain PyTorch: the NeRF emitter's plain
query, the NeRF pretraining step and the takeover's schedule around the
SDF step. Frozen copies of the port's `pipelines/nerf_emitter.py`
(`make_nerf_emitter_fn`'s plain branch, `fold_in` and
`NerfEmitterPipeline`'s takeover schedule) and `engine/train_loop.py` (`nerfacto_loss`,
`make_train_step`), with the departures named where they are:

- one rank only (the port's row split over ranks is left out);
- the emitter is always the model's own forward (the port serves it
  through its K5 kernel on the card);
- the march is eager (renderer/sphere_trace.py);
- the caller makes the TF32 switches off (`tf32_off`) before it runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from typing import Optional

import torch

from .cameras.cameras import Cameras
from .cameras.rays import RayBundle
from .data.datamanager import generate_train_rays, sample_pixel_batch
from .engine.optimizers import OptimizerGroupConfig, build_optimizer
from .engine.schedulers import proposal_anneal_schedule
from .fields.mlp import MLP
from .guiding.path_guiding import VMFGuiding
from .ops import losses as L
from .ops.colliders import aabb_far_intersect_collider
from .pipelines.sdf_optimizer import SdfOptState, TakeoverConfig, build_sdf_optimizer, make_sdf_train_step, post_step_host
from .renderer.integrator import RenderConfig
from .renderer.optimize import SdfOptConfig
from .renderer.scene import SdfScene
from .utils import coords
from .utils.device import id_column


@contextlib.contextmanager
def tf32_off():
    """Float32 matmuls and convolutions in full float32 while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def set_precision(model: torch.nn.Module, precision: str) -> None:
    """Every MLP of `model` computes in `precision`: "bf16" (the
    configuration's) or "fp8" (the control)."""
    for m in model.modules():
        if isinstance(m, MLP):
            m.operand_precision = precision


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator seeded from `generator`'s state and `data`."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()
                            + int(data).to_bytes(8, "little", signed=True)).digest()
    return torch.Generator(device=generator.device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


class _ChunkedQuery(torch.autograd.Function):
    """query(x, d) -> (n, 3) over chunks of rows: the forward without a
    graph, the backward recomputing each chunk with one (the port's kernel
    query recomputes its backward the same way), so that memory stays
    bounded by one chunk at any batch."""

    @staticmethod
    def forward(ctx, x, d, query, chunk):
        ctx.query, ctx.chunk = query, chunk
        ctx.save_for_backward(x, d)
        with torch.no_grad():
            return torch.cat([query(x[i:i + chunk], d[i:i + chunk]) for i in range(0, x.shape[0], chunk)])

    @staticmethod
    def backward(ctx, g):
        x, d = ctx.saved_tensors
        gx, gd = [], []
        for i in range(0, x.shape[0], ctx.chunk):
            with torch.enable_grad():
                xi = x[i:i + ctx.chunk].detach().requires_grad_()
                di = d[i:i + ctx.chunk].detach().requires_grad_()
                a, b = torch.autograd.grad(ctx.query(xi, di), (xi, di), g[i:i + ctx.chunk])
            gx.append(a)
            gd.append(b)
        return torch.cat(gx), torch.cat(gd), None, None


def make_emitter_fn_of(model, scene_scale: float, object_aabb, far: float = 1e3, chunk: int = 1 << 14):
    """emitter_fn_of(camera_index=None) -> emitter_fn(x_unit, d) -> (n, 3)
    radiance: rays from the object box's exit, the NeRF's density carved
    out inside the box, the NeRF detached (it gets no gradient). Departure:
    the query runs in chunks of `chunk` rays (_ChunkedQuery)."""
    device = model.device
    box = torch.as_tensor(object_aabb, dtype=torch.float32, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}

    def emitter_fn_of(camera_index=None):
        def query(x_unit: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            o_w = coords.unit_to_world(x_unit, scene_scale)
            n = o_w.shape[0]
            cam = id_column(0 if camera_index is None else camera_index, (n, 1), o_w.device)
            rays = RayBundle(origins=o_w, directions=d, pixel_area=torch.full((n, 1), 1e-4, device=o_w.device),
                             nears=torch.zeros((n, 1), device=o_w.device),
                             fars=torch.full((n, 1), far, device=o_w.device), camera_indices=cam)
            rays = aabb_far_intersect_collider(rays, box, far=far)
            out = torch.func.functional_call(
                model, params, (rays,), dict(train=False, hdr_radiance_only=True, disable_aabb=box,
                                             disable_aabb_on=True), strict=False)
            return out["rgb"]

        def emitter_fn(x_unit: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            return _ChunkedQuery.apply(x_unit, d, query, chunk)

        return emitter_fn

    return emitter_fn_of


# ---- NeRF pretraining


@dataclasses.dataclass(frozen=True)
class NerfTrainConfig:
    """The pretraining settings the step reads (the port's TrainConfig)."""

    num_rays_per_batch: int = 1 << 14
    near: float = 0.05
    far: float = 1e3
    rgb_loss: str = "rawnerf"
    rgb_loss_second: Optional[str] = "relative_l1"
    interlevel_mult: float = 1.0
    distortion_mult: float = 0.002
    anneal_steps: int = 1000
    anneal_slope: float = 10.0
    max_steps: int = 2320
    lr_fields: float = 1e-3
    lr_proposal: float = 1e-3
    lr_final_ratio: float = 0.1
    step_pretrain: Optional[int] = 2000


def build_nerf_optimizer(config: NerfTrainConfig, model):
    groups = {
        "fields": OptimizerGroupConfig(lr=config.lr_fields, lr_final=config.lr_fields * config.lr_final_ratio,
                                       max_steps=config.max_steps, step_pretrain=config.step_pretrain,
                                       lr_lambda=0.01),
        "proposal_networks": OptimizerGroupConfig(lr=config.lr_proposal,
                                                  lr_final=config.lr_proposal * config.lr_final_ratio,
                                                  max_steps=config.max_steps, step_pretrain=config.step_pretrain,
                                                  lr_lambda=0.01),
        "camera_opt": OptimizerGroupConfig(lr=1e-3, max_steps=config.max_steps),
    }
    return build_optimizer(groups, model.named_parameters())


def nerf_train_step(model, config: NerfTrainConfig, optimizer, step: int, cameras: Cameras, images: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """One pretraining step on a fresh pixel batch drawn from `generator`;
    returns the step's loss."""
    cam, yx, gt, _ = sample_pixel_batch(generator, images, config.num_rays_per_batch)
    rays = generate_train_rays(cameras, cam, yx, generator, near=config.near, far=config.far)
    anneal = proposal_anneal_schedule(config.anneal_steps, config.anneal_slope)(step)
    with torch.enable_grad():
        out = model(rays, generator=generator, train=True, proposal_anneal=anneal)
        fns = [L.RGB_LOSSES[config.rgb_loss]] + ([L.RGB_LOSSES[config.rgb_loss_second]]
                                                 if config.rgb_loss_second else [])
        rgb_loss = sum(f(out["rgb"], gt) for f in fns) / len(fns)
        il = L.interlevel_loss(out["weights_list"], out["spacing_bins_list"])
        rs = out["ray_samples"]
        dl = L.distortion_loss(out["weights_list"][-1], rs.spacing_starts, rs.spacing_ends)
        total = rgb_loss + config.interlevel_mult * il + config.distortion_mult * dl
        optimizer.zero_grad()
        total.backward()
    optimizer.step()
    return total.detach()


# ---- the takeover


@dataclasses.dataclass(frozen=True)
class TakeoverSettings:
    """The pipeline settings the takeover's schedule reads."""

    object_aabb: tuple = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
    scene_scale: float = 1.0
    batch_size: int = 2
    spp: int = 16
    spp_attached: int = 8
    takeover_image_size: int = 64
    mi_opt_steps: int = 320
    mis_mode: str = "one_sample"
    reparam: str = "soft"
    warp_secondary: bool = False


class Takeover:
    """The takeover's state and schedule around the SDF step (the port's
    NerfEmitterPipeline from begin_takeover on): the sphere start, the
    step at the schedule's render size and spp, the volume upsample's lr
    decay, post_step_host."""

    def __init__(self, settings: TakeoverSettings, opt_config: SdfOptConfig, emitter_for_camera, image_hw: int,
                 device):
        self.s, self.opt_config, self.device = settings, opt_config, device
        self.emitter_for_camera = emitter_for_camera
        self.cap = image_hw
        self.render_config = RenderConfig(mis_mode=settings.mis_mode, reparam=settings.reparam,
                                          warp_secondary=settings.warp_secondary)
        self.guiding = VMFGuiding(scene_scale=settings.scene_scale,
                                  mis_compensation=self.render_config.guiding_mis_compensation)
        self.size, self.spp, self.lr_up_scale = settings.takeover_image_size, settings.spp, {}
        self.state = None
        self.tx = self.step_fn = None

    def sphere_scene(self) -> SdfScene:
        box = torch.as_tensor(self.s.object_aabb, dtype=torch.float32, device=self.device)
        half = float(torch.min(box[1] - box[0])) * 0.5
        radius = min(0.45, max(0.05, 0.8 * half / (2.0 * self.s.scene_scale)))
        return SdfScene.create(sdf_res=self.opt_config.init_res, tex_res=self.opt_config.tex_res,
                               bsdf_type=self.opt_config.bsdf_type, init_radius=radius, device=self.device)

    def begin(self, scene: SdfScene, step: int) -> None:
        """The optimiser's fresh state on `scene` (its guiding already
        built), at takeover step `step`."""
        self.tx = build_sdf_optimizer(self.opt_config)
        self.state = SdfOptState(step=step, scene=scene, opt_state=self.tx.init(scene), mean_params=None)
        self._rebuild()

    def _rebuild(self) -> None:
        spp = self.spp
        t = TakeoverConfig(spp=spp, spp_per_batch=min(TakeoverConfig.spp_per_batch, spp),
                           spp_attached=min(self.s.spp_attached, spp) if self.s.spp_attached > 0 else 0,
                           image_height=self.size, image_width=self.size, scene_scale=self.s.scene_scale,
                           mean_start_step=max(0, self.s.mi_opt_steps - 64))
        self.step_fn = make_sdf_train_step(self.opt_config, t, self.tx, render_config=self.render_config,
                                           emitter_for_camera=self.emitter_for_camera)

    def iteration(self, cameras: Cameras, images, masks, cam_idx, draws) -> dict:
        """One takeover step on the given cameras and draws (no guiding
        rebuild: the reference follows steps between two rebuilds)."""
        mi_step = int(self.state.step)
        if mi_step in self.opt_config.render_upsample_iter:
            new = min(self.size * 2, self.cap)
            if new != self.size:
                self.size = new
                if new >= 512 and self.spp > 1:
                    self.spp = max(1, self.spp // 2)
                self._rebuild()
        self.state, metrics = self.step_fn(self.state, cameras, cam_idx, images[cam_idx], masks[cam_idx],
                                           draws=draws)
        pre = self.state.scene.sdf.shape
        self.state = post_step_host(self.state, self.opt_config, self.tx)
        if self.state.scene.sdf.shape != pre:
            decays = {v.name: v.lr_decay_at_up for v in self.opt_config.variables if v.lr_decay_at_up != 1.0}
            if decays:
                for name, dec in decays.items():
                    self.lr_up_scale[name] = self.lr_up_scale.get(name, 1.0) * dec
                self.tx = build_sdf_optimizer(self.opt_config, self.lr_up_scale)
                self.state = self.state.replace(opt_state=self.tx.init(self.state.scene))
                self._rebuild()
        return metrics

