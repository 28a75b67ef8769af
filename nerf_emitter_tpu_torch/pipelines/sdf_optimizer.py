"""The takeover's SDF optimisation step (port of
nerf_emitter_tpu/pipelines/sdf_optimizer.py).

One step, for each of the batch's images: render the SDF scene at the
image's camera (spp samples in checkpointed slices), then the view, mask
and curvature losses and the Laplacian regulariser; then one update of
sdf, albedo and roughness from the NaN-swept gradients; then, on the host
(`post_step_host`), the clamps, the scheduled redistancing and the volume
upsample schedule.

Each image (and, in aggregate mode, each band of pixel rows) is its own
backward, and the gradients accumulate: memory stays bounded by one band's
attached render, and the sum is the whole batch's gradient. The step draws
its random numbers from a `torch.Generator`, or takes them as a list of
`ImageDraws` (one per image), so a test can hand it another package's
draws.

Across ranks (`mesh`, parallel/mesh.py) every rank draws the whole
step's random numbers, renders its rows of each image's pixel rays (in the
detached chunks and in the attached bands, the draws cut to the same
rows) and gathers the rows, so the view and mask losses are the batch's
means on every rank; the gradients, each rank's from its own rows, are
summed over the ranks, and the Laplacian on the replicated grid adds its
gradient on rank 0 alone, so that it counts once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..cameras.cameras import Cameras
from ..ops import losses as L
from ..parallel.mesh import Mesh, all_reduce_grads, data_sharded, gather_rows, shard_axis
from ..renderer.integrator import EmitterFn, RenderConfig, draw_direct, render_curvature, render_spp
from ..renderer.optimize import (GradientTransform, SdfOptConfig, adam, chain, laplacian_reg, maybe_upsample,
                                 sobolev_preconditioner, uniform_adam, validate_gradients, validate_params)
from ..renderer.scene import SdfScene
from ..renderer.sensors import camera_rays_in_render_space
from ..renderer.spp_schedule import divide_spp
from ..utils import profiler

OPTIMIZED_VARS = ("sdf", "albedo", "roughness")


@dataclasses.dataclass
class SdfOptState:
    step: int
    scene: SdfScene
    opt_state: dict
    # running (Polyak) means of the optimised volumes, swapped in at the
    # load-mean step; None: no tracking
    mean_params: Optional[dict] = None
    mean_count: int = 0

    def replace(self, **kw) -> "SdfOptState":
        return dataclasses.replace(self, **kw)


def init_mean_params(scene: SdfScene) -> dict:
    """The running means, started at copies of the optimised volumes."""
    return {name: getattr(scene, name).clone() for name in OPTIMIZED_VARS}


def load_mean_parameters(state: SdfOptState) -> SdfOptState:
    """Swap the running means into the scene; a no-op without tracking."""
    if state.mean_params is None:
        return state
    return state.replace(scene=state.scene.replace(**state.mean_params))


class SdfOptimizer:
    """optax.multi_transform over the scene: one transform per optimised
    variable; the envmap and the guiding mixture are frozen (never
    updated)."""

    def __init__(self, txs: dict[str, GradientTransform]):
        self.txs = txs

    def init(self, scene: SdfScene) -> dict:
        return {name: tx.init(getattr(scene, name)) for name, tx in self.txs.items()}

    def update(self, grads: dict, state: dict) -> tuple[dict, dict]:
        updates, new_state = {}, {}
        for name, tx in self.txs.items():
            updates[name], new_state[name] = tx.update(grads[name], state[name])
        return updates, new_state


def build_sdf_optimizer(config: SdfOptConfig, lr_scale: Optional[dict] = None) -> SdfOptimizer:
    """Per variable: Adam (eps 1e-15), or with smooth_lam > 0 the Sobolev
    smoothing of the raw gradient then the chosen moment step. `lr_scale`
    maps a variable to its accumulated volume-upsample lr decay."""
    lr_scale = lr_scale or {}
    specs = {v.name: v for v in config.variables}
    txs = {}
    for name in OPTIMIZED_VARS:
        spec = specs.get(name)
        lr = spec.lr * lr_scale.get(name, 1.0) if spec is not None else 1e-3
        lam = spec.smooth_lam if spec is not None else 0.0
        kind = spec.optimizer if spec is not None else "adam"
        step = uniform_adam(lr) if kind == "uniform_adam" else adam(lr, eps=1e-15)
        txs[name] = chain(sobolev_preconditioner(lam), step) if lam > 0 else step
    return SdfOptimizer(txs)


@dataclasses.dataclass(frozen=True)
class TakeoverConfig:
    spp: int = 32
    spp_per_batch: int = 8
    image_height: int = 64
    image_width: int = 64
    scene_scale: float = 1.0
    laplacian_mult: float = 1e-2
    mask_loss_mult: float = 10.0
    use_mask_loss: bool = True
    # > 0 selects the aggregate estimator (the reference's
    # render_aggregate): the primal image is the mean over all spp, the
    # spp - spp_attached detached samples rendered in chunks, while the
    # gradient flows through spp_attached attached samples, banded over
    # pixel rows. spp_attached == spp keeps the bands with exact gradients.
    spp_attached: int = 0
    # the step from which the running means accumulate
    mean_start_step: int = 0


@dataclasses.dataclass
class ImageDraws:
    """The random numbers of one image of a step:
    - jitter (H*W, 2): the view rays' sub-pixel offsets;
    - chunks: the detached chunks' DirectDraws, each (chunk_spp, H*W)-leading
      (aggregate mode; none in exact mode);
    - bands: the attached render's DirectDraws per gradient band,
      (spp_attached, band rays)-leading (exact mode: one band, (spp, H*W));
    - curv_jitter: per band, the curvature rays' offsets (H*W, 2)."""

    jitter: torch.Tensor
    chunks: list
    bands: list
    curv_jitter: list


def resize_image(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W, C) -> (h, w, C), bilinear with half-pixel centres, antialiased
    when it shrinks (jax.image.resize's "linear")."""
    if x.shape[:2] == (h, w):
        return x
    return F.interpolate(x.permute(2, 0, 1)[None], size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)[0].permute(1, 2, 0)


class SdfTrainStep:
    """step(state, cameras, cam_indices, gt_images, gt_masks, generator=None,
    *, draws=None, occ_layers=None) -> (state, metrics). gt_images
    (B, H, W, 3) and gt_masks (B, H, W, 1) are resized to the render size;
    cam_indices (B,).

    - emitter_for_camera(cam_idx, rot_id) -> EmitterFn builds each image's
      emitter (appearance embedding, turntable rotation) and takes
      precedence over emitter_fn;
    - rotater + camera_rot_ids rotate each image's rays into the object's
      canonical frame;
    - use_occlusion: the step takes occ_layers = (occlusion_rgb (B, h, w, 3),
      occlusion_mask (B, h, w, 1), background_rgb (B, h, w, 3)); the render
      is composited over the background and under the occluders before the
      view loss, and the mask loss is weighted by 1 - occlusion_mask.

    Exact mode (spp_attached 0, or above spp): each image renders spp
    attached samples. Aggregate mode: each image renders its detached
    chunks (`chunks`, divide_spp of spp - spp_attached by spp_per_batch,
    each chunk one slice of chunk_spp samples), then spp_attached attached
    samples in `n_grad_bands` bands of `band_h` rows: the bands double
    until pixels x spp_attached per band fit NERF_EMITTER_GRAD_BAND_BUDGET
    (default 128 * 128 * 16), read when the step is built.

    mesh + data_axis split every render's rays over the ranks (see the
    module's docstring); the step then equals the one-rank step."""

    def __init__(
        self,
        opt_config: SdfOptConfig,
        takeover: TakeoverConfig,
        tx: SdfOptimizer,
        emitter_fn: Optional[EmitterFn] = None,
        render_config: RenderConfig = RenderConfig(),
        mesh: Optional[Mesh] = None,
        data_axis: Optional[str] = None,
        emitter_for_camera: Optional[Callable] = None,
        rotater=None,
        camera_rot_ids: Optional[torch.Tensor] = None,
        use_occlusion: bool = False,
    ):
        self.mesh = mesh if mesh is not None and data_axis is not None and mesh.world_size > 1 else None
        self.opt_config, self.takeover, self.tx = opt_config, takeover, tx
        self.emitter_fn, self.render_config = emitter_fn, render_config
        self.emitter_for_camera, self.rotater, self.camera_rot_ids = emitter_for_camera, rotater, camera_rot_ids
        self.use_occlusion = use_occlusion
        self.loss_fn_rgb = L.RGB_LOSSES[opt_config.loss]
        h, w = takeover.image_height, takeover.image_width
        spp_att = takeover.spp_attached
        self.aggregate = spp_att > 0 and takeover.spp >= spp_att
        if self.aggregate:
            self.chunks = divide_spp(takeover.spp - spp_att, max(1, takeover.spp_per_batch))
            budget = int(os.environ.get("NERF_EMITTER_GRAD_BAND_BUDGET", 128 * 128 * 16))
            n_bands = 1
            while (h * w * spp_att) // n_bands > budget and n_bands < h:
                n_bands *= 2
            self.n_grad_bands, self.band_h, self.band_spp = n_bands, max(1, h // n_bands), spp_att
        else:
            self.chunks, self.n_grad_bands, self.band_h, self.band_spp = [], 1, h, takeover.spp

    # ---- pieces shared by both modes

    def _cameras(self, cameras: Cameras) -> Cameras:
        """Intrinsics rescaled to the render resolution."""
        h, w = self.takeover.image_height, self.takeover.image_width
        if cameras.height == h and cameras.width == w:
            return cameras
        sy, sx = h / cameras.height, w / cameras.width
        return Cameras(camera_to_worlds=cameras.camera_to_worlds, fx=cameras.fx * sx, fy=cameras.fy * sy,
                       cx=cameras.cx * sx, cy=cameras.cy * sy, width=w, height=h,
                       camera_type=cameras.camera_type)

    def _rot_id(self, cam_idx):
        if self.rotater is None or self.camera_rot_ids is None:
            return None
        return self.camera_rot_ids[cam_idx]

    def _rays(self, cameras, cam_idx, jitter):
        t = self.takeover
        return camera_rays_in_render_space(self._cameras(cameras), cam_idx, t.image_height, t.image_width,
                                           t.scene_scale, jitter=jitter, rotater=self.rotater,
                                           rot_id=self._rot_id(cam_idx))

    def _emitter(self, cam_idx):
        if self.emitter_for_camera is not None:
            return self.emitter_for_camera(cam_idx, self._rot_id(cam_idx))
        return self.emitter_fn

    def draw(self, scene: SdfScene, batch: int, generator: Optional[torch.Generator] = None) -> list[ImageDraws]:
        """A step's random numbers for `batch` images."""
        t = self.takeover
        hw, band_rays = t.image_height * t.image_width, self.band_h * t.image_width
        dev = scene.sdf.device

        def u2():
            return torch.rand((hw, 2), generator=generator, device=dev)

        return [ImageDraws(jitter=u2(),
                           chunks=[draw_direct(scene, hw, generator, dev, lead=(c,)) for c in self.chunks],
                           bands=[draw_direct(scene, band_rays, generator, dev, lead=(self.band_spp,))
                                  for _ in range(self.n_grad_bands)],
                           curv_jitter=[u2() for _ in range(self.n_grad_bands)])
                for _ in range(batch)]

    def _render_rows(self, scene, o, d, spp, draws, em, spp_per_batch, keys=("rgb", "soft_mask")):
        """render_spp of the rays o, d (n, 3) with their (spp, n)-leading
        draws; with a mesh, of this rank's rows, gathered."""
        if self.mesh is None:
            return render_spp(scene, o, d, spp, draws=draws, emitter_fn=em, config=self.render_config,
                              spp_per_batch=spp_per_batch)
        n, mesh = o.shape[0], self.mesh
        out = render_spp(scene, data_sharded(o, mesh), data_sharded(d, mesh), spp,
                         draws=draws.map(lambda x: shard_axis(x, mesh, 1)), emitter_fn=em,
                         config=self.render_config, spp_per_batch=spp_per_batch)
        return {k: gather_rows(out[k], mesh, n) for k in keys}

    def _curvature(self, scene, o, d):
        if self.mesh is None:
            return render_curvature(scene, o, d, self.render_config,
                                    curvature_epsilon=self.opt_config.curvature_epsilon)
        c = render_curvature(scene, data_sharded(o, self.mesh), data_sharded(d, self.mesh), self.render_config,
                             curvature_epsilon=self.opt_config.curvature_epsilon)
        return gather_rows(c, self.mesh, o.shape[0])

    def _band_loss(self, scene, cameras, cam_idx, em, o, d, det_sum, gt, mask, occ, band, dr: ImageDraws):
        """The loss terms of one band of rows of one image, each weighted by
        the band's share of the rows (the terms then sum to the image's)."""
        t, cfg = self.takeover, self.render_config
        h, w = t.image_height, t.image_width
        band_h = self.band_h
        rows = slice(band * band_h * w, (band + 1) * band_h * w)
        out = self._render_rows(scene, o[rows], d[rows], self.band_spp, dr.bands[band], em, t.spp_per_batch)
        pred = out["rgb"]
        if self.aggregate:
            # the primal is the full-spp mean; the gradient flows through
            # the attached samples at scale 1 (the reference's
            # img - detach(img) + img_sum / n)
            mean = (det_sum[rows] + pred * t.spp_attached) / t.spp
            pred = pred + (mean - pred).detach()
        pred = pred.reshape(band_h, w, 3)
        soft = out["soft_mask"].reshape(band_h, w, 1)
        r0, r1 = band * band_h, (band + 1) * band_h
        gt_b, mask_b = gt[r0:r1], mask[r0:r1]
        mask_weight = torch.ones_like(mask_b)
        if occ is not None:
            # occluders over (render over background); silhouette
            # supervision only where no occluder hides the object
            o_rgb, o_m, bg = (resize_image(x, h, w)[r0:r1] for x in occ)
            pred = o_rgb * o_m + (pred * soft + bg * (1.0 - soft)) * (1.0 - o_m)
            mask_weight = 1.0 - o_m
        frac = band_h / h
        view_loss = self.loss_fn_rgb(pred, gt_b) * frac
        mask_loss = torch.mean(mask_weight * (soft - mask_b) ** 2) * frac
        oc, dc = self._rays(cameras, cam_idx, dr.curv_jitter[band])
        curv = frac * torch.mean(self._curvature(scene, oc[rows], dc[rows]))
        lap = frac * laplacian_reg(scene.sdf)
        if self.mesh is not None and not self.mesh.is_main:
            lap = lap.detach()  # a term of the replicated grid: its gradient is rank 0's alone
        # the reference's exact mode reports a mask loss of 0 when it is
        # off; its aggregate mode reports it anyway
        use_mask = t.use_mask_loss or self.aggregate
        total = (view_loss + (t.mask_loss_mult * mask_loss if t.use_mask_loss else 0.0)
                 + self.opt_config.curvature_mult * curv + t.laplacian_mult * lap)
        return total, {"loss": total, "view_loss": view_loss,
                       "mask_loss": mask_loss if use_mask else torch.zeros_like(mask_loss),
                       "curvature": curv, "laplacian": lap}

    def __call__(self, state: SdfOptState, cameras: Cameras, cam_indices, gt_images, gt_masks,
                 generator: Optional[torch.Generator] = None, *, draws: Optional[list] = None,
                 occ_layers=None):
        if (occ_layers is not None) != self.use_occlusion:
            raise ValueError("occ_layers are given exactly when the step is built with use_occlusion")
        t = self.takeover
        if draws is None:
            draws = self.draw(state.scene, gt_images.shape[0], generator)
        with torch.enable_grad():  # also under a caller's no_grad (a profiler, say)
            grads, metrics = self._grads(state.scene, cameras, cam_indices, gt_images, gt_masks, draws, occ_layers)
        new_state, metrics = self._apply(state, grads, metrics)
        metrics["estimator_aggregate"] = 1.0 if self.aggregate and t.spp_attached < t.spp else 0.0
        return new_state, metrics

    def _grads(self, scene0: SdfScene, cameras, cam_indices, gt_images, gt_masks, draws, occ_layers):
        """The batch's mean gradient of each optimised variable and the mean
        loss terms: one backward per image and band."""
        t = self.takeover
        h, w = t.image_height, t.image_width
        b = gt_images.shape[0]
        params = {name: getattr(scene0, name).detach().requires_grad_() for name in OPTIMIZED_VARS}
        scene = scene0.replace(**params)
        grads = {name: None for name in OPTIMIZED_VARS}
        metrics = None
        for i in range(b):
            cam_idx, dr = cam_indices[i], draws[i]
            em = self._emitter(cam_idx)
            o, d = self._rays(cameras, cam_idx, dr.jitter)
            det_sum = None
            if self.aggregate:
                det_sum = torch.zeros((h * w, 3), device=o.device)
                with torch.no_grad(), profiler.span("sdf.detached"):
                    for c, cd in zip(self.chunks, dr.chunks):
                        det_sum = det_sum + self._render_rows(scene, o, d, c, cd, em, c, keys=("rgb",))["rgb"] * c
            gt, mask = resize_image(gt_images[i], h, w), resize_image(gt_masks[i], h, w)
            occ = None if occ_layers is None else tuple(x[i] for x in occ_layers)
            for band in range(self.n_grad_bands):
                with profiler.span("sdf.band_forward"):
                    total, m = self._band_loss(scene, cameras, cam_idx, em, o, d, det_sum, gt, mask, occ, band, dr)
                with profiler.span("sdf.band_backward"):
                    gs = torch.autograd.grad(total, [params[k] for k in OPTIMIZED_VARS], allow_unused=True)
                    for k, g in zip(OPTIMIZED_VARS, gs):
                        if g is not None:
                            grads[k] = g if grads[k] is None else grads[k] + g
                m = {k: v.detach() for k, v in m.items()}
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
        if self.mesh is not None:
            for k, g in grads.items():
                params[k].grad = g
            all_reduce_grads([params[k] for k in OPTIMIZED_VARS], self.mesh)
            grads = {k: params[k].grad for k in OPTIMIZED_VARS}
        grads = {k: torch.zeros_like(params[k]) if g is None else g / b for k, g in grads.items()}
        return grads, {k: v / b for k, v in metrics.items()}

    @profiler.span("sdf.apply")
    @torch.no_grad()
    def _apply(self, state: SdfOptState, grads: dict, metrics: dict):
        grads = validate_gradients(grads)
        metrics = dict(metrics)
        for name in OPTIMIZED_VARS:
            # per-variable gradient norms: the divergence diagnostic
            metrics[f"gnorm_{name}"] = torch.linalg.vector_norm(grads[name])
        updates, opt_state = self.tx.update(grads, state.opt_state)
        scene = state.scene.replace(**{k: getattr(state.scene, k) + u for k, u in updates.items()})
        means, c = state.mean_params, state.mean_count
        if means is not None and state.step >= self.takeover.mean_start_step:
            # uniform running mean: m_k = m_{k-1} + (theta_k - m_{k-1}) / k
            c = c + 1
            means = {k: m + (getattr(scene, k) - m) * (1.0 / c) for k, m in means.items()}
        return SdfOptState(step=state.step + 1, scene=scene, opt_state=opt_state, mean_params=means,
                           mean_count=c), metrics


def make_sdf_train_step(opt_config: SdfOptConfig, takeover: TakeoverConfig, tx: SdfOptimizer,
                        emitter_fn: Optional[EmitterFn] = None, render_config: RenderConfig = RenderConfig(),
                        **kwargs) -> SdfTrainStep:
    """The takeover step (SdfTrainStep) for this recipe, render size and
    emitter."""
    return SdfTrainStep(opt_config, takeover, tx, emitter_fn, render_config, **kwargs)


def post_step_host(state: SdfOptState, opt_config: SdfOptConfig, tx: SdfOptimizer) -> SdfOptState:
    """The host's schedule after a step: clamps and redistancing, then the
    volume upsample, which changes shapes; after an upsample the
    optimiser's state and the running means start afresh."""
    scene = validate_params(state.scene, opt_config, state.step)
    new_scene = maybe_upsample(scene, opt_config, state.step)
    if new_scene.sdf.shape != scene.sdf.shape:
        return SdfOptState(step=state.step, scene=new_scene, opt_state=tx.init(new_scene),
                           mean_params=init_mean_params(new_scene) if state.mean_params is not None else None,
                           mean_count=0)
    return state.replace(scene=scene)
