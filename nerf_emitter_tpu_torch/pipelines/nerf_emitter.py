"""The NeRF-as-emitter pipeline (port of nerf_emitter_tpu/pipelines/nerf_emitter.py):
the emitter query closure, the gate that picks what serves it, and the
two-phase driver.

Phase schedule (sdf-nerfacto): steps below `takeover_step` pretrain the
NeRF (engine/train_loop.py); at the takeover the SDF starts from a TSDF
fusion of the NeRF's depth, the vMF guiding mixture is built and the
emitter is set up (the distilled light-field cache, taught by the full
query, or the full query itself); every later step optimises the SDF
scene lit by that emitter, rebuilding the guiding every 10 takeover steps,
doubling the render size at the volume upsamples and decaying their lr,
and swapping in the running means at the load-mean step.

The pipeline draws its random numbers from a `torch.Generator` where the
reference takes a JAX key. Across ranks (`mesh`, `data_axis`;
parallel/mesh.py) the NeRF and SDF states are replicated: rank 0's are
broadcast at the start, and what a rank computes on its own (the TSDF
scene, the guiding mixture, the distilled student, the learned denoiser)
is broadcast from rank 0 after it, so the replicas cannot drift; the
steps and the views split their rays over the ranks.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import torch

from ..cameras.cameras import Cameras
from ..cameras.rays import RayBundle
from ..data.datamanager import ImageDataset
from ..data.occlusion import render_occlusion_layers
from ..data.scene_box import CropMode, SceneBox
from ..engine.train_loop import TrainConfig, create_train_state, eval_image_metrics, make_render_fn, make_train_step
from ..guiding.path_guiding import EmitterImageGuiding, EnvGuiding, VMFGuiding
from ..models.nerfacto import NerfactoModel
from ..ops.colliders import aabb_far_intersect_collider
from ..ops.fused_field import named_params
from ..ops.mega_query import RAY_PADS, chunked_forward, make_mega_radiance_query, recompute_grads
from ..parallel.mesh import Mesh, data_sharded, fill_rows, gather_rows, replicated, shard_axis, sum_gradients
from ..renderer.emitters import VMFMixture
from ..renderer.grid3d import sphere_sdf_grid, upsample_grid
from ..renderer.integrator import RenderConfig, draw_direct, render_spp
from ..renderer.learned_denoise import DenoiserConfig, apply_denoiser, fit_denoiser
from ..renderer.optimize import SdfOptConfig
from ..renderer.scene import SdfScene
from ..renderer.sensors import camera_rays_in_render_space
from ..renderer.sphere_trace import clear_march_graphs
from ..renderer.spp_schedule import bilateral_denoise, divide_spp
from ..serving.distill import DistillConfig, distill_emitter, make_student_emitter_fn_of
from ..utils import coords, profiler
from ..utils.device import id_column
from ..utils.locks import FairLock
from . import tsdf
from .sdf_optimizer import (SdfOptState, TakeoverConfig, build_sdf_optimizer, init_mean_params, load_mean_parameters,
                            make_sdf_train_step, post_step_host)


def serves_kernel_query(model, use_fused: bool) -> bool:
    """Whether the emitter query runs on the kernel query (K5) rather
    than the model's forward: only for `implementation == "freq"` with the
    fake contraction (what the kernels compute) on a model on CUDA, and
    only when asked (`use_fused`). The reference gates the same way (freq
    on its TPU backend). The decision reads the configuration alone; a
    kernel that then fails to build or launch raises. Where it says no,
    `make_nerf_emitter_fn` runs the model's forward in chunks
    (`_ChunkedQuery`; the `hash` field's encoding is K7 on the card)."""
    return (
        bool(use_fused)
        and model.implementation == "freq"
        and bool(model.use_fake_contraction)
        and model.device.type == "cuda"
    )


class _ChunkedQuery(torch.autograd.Function):
    """The emitter query through the model's forward, in RECOMPUTE_RAYS-row
    chunks (ops/mega_query.py): query(rows, params) -> (radiance, the final
    samples' spacing edges) of the rows {"origins": world-space origins,
    "directions": ..., and "spacing_bins" where the edges are given} with
    the parameters `params` (the model's, in its order). The forward
    answers each chunk without a graph and keeps the rays and the edges,
    (num_nerf_samples + 1) values a ray; the backward recomputes each
    chunk from its edges with a graph, the field's samples alone, and
    returns the gradients of the origins, the directions and the
    parameters that require one. The proposal resample stops the gradient
    at its weights, so the edges are constants, as the bins of the kernel
    query's frozen backward are. Memory holds one chunk's graph whatever
    the batch; the model's forward in one call keeps ~173 KB a ray with a
    gradient at nerfacto's published widths."""

    @staticmethod
    def forward(ctx, query, origins, directions, *params):
        ctx.query = query
        rgb, bins = chunked_forward(lambda rows: query(rows, params),
                                    {"origins": origins, "directions": directions}, origins.shape[0])
        ctx.save_for_backward(origins, directions, bins, *params)
        return rgb

    @staticmethod
    @profiler.span("emitter.backward")
    def backward(ctx, g):
        origins, directions, bins, *params = ctx.saved_tensors
        need = dict(zip(("origins", "directions"), ctx.needs_input_grad[1:3]))
        leaves = [t.detach().requires_grad_(nd) for t, nd in zip(params, ctx.needs_input_grad[3:])]
        fields = {"origins": origins, "directions": directions, "spacing_bins": bins}
        ray_grads, param_grads = recompute_grads(lambda rows, ps: ctx.query(rows, ps)[0], fields, need, leaves, g)
        return (None, *ray_grads, *param_grads)


def shard_fused_query(query, mesh: Optional[Mesh]):
    """The kernel query split over the ranks by rows of the ray batch (the
    reference's pad_scatter / pad_gather of emitter rays,
    mitsuba_sdf.py:878-912; the JAX package's shard_map). The caller holds
    a replicated batch: it is padded to a multiple of the world size with
    the reference's pad values (RAY_PADS), each rank runs the kernel on
    its rows, the rows are gathered and the padding dropped. The
    parameters' gradients are summed over the ranks in the backward, so
    they equal the one-rank gradient, as do the rays'."""
    if mesh is None or mesh.world_size == 1:
        return query

    def sharded(params, rays: RayBundle, camera_index=None):
        n = rays.origins.shape[0]
        m = n + (-n) % mesh.world_size
        fields = {f.name: getattr(rays, f.name) for f in dataclasses.fields(RayBundle)}
        local = RayBundle(**{k: None if x is None else data_sharded(fill_rows(x, m, RAY_PADS[k]), mesh)
                             for k, x in fields.items()})
        p = {k: sum_gradients(v, mesh) for k, v in named_params(params).items()}
        return gather_rows(query(p, local, camera_index=camera_index), mesh, n)

    return sharded


def make_nerf_emitter_fn(
    model: NerfactoModel,
    scene_scale: float,
    object_aabb,
    *,
    far: float = 1e3,
    detach_nerf: bool = False,
    rotater=None,
    use_fused: bool = True,
    mesh=None,
    data_axis: Optional[str] = None,
    samples_override: Optional[tuple] = None,
):
    """Returns emitter_fn_of(params=None, camera_index=None, rot_id=None)
    -> emitter_fn(x_unit, d) -> radiance (n, 3).

    - rays escape the object region: they start at the object-box exit
      (the far-intersect collider), and NeRF density inside the object box
      is zero (the carve-out);
    - `params` is the model (None: the model given here) or a {name: tensor}
      dict of its parameters, each of which that requires a gradient gets
      one; `detach_nerf` detaches them, so that the NeRF gets no gradient
      (the takeover's frozen emitter); the rays' origins and directions
      get theirs either way;
    - `camera_index` picks the appearance embedding;
    - `rotater` + `rot_id` map the canonical object-frame query ray into
      the world (light) frame for turntable captures, after the collider
      (the object box lives in the canonical frame; near and far are
      distances along the ray, which the rigid rotation keeps);
    - the route, of two: `use_fused` serves the query through the kernel
      query (ops/mega_query.py: K5 forward; backward K3 and K6 with the
      NeRF frozen, the staged recompute with a NeRF parameter trained)
      where `serves_kernel_query` says so; otherwise the model's own
      forward serves it, in RECOMPUTE_RAYS-row chunks recomputed in the
      backward (`_ChunkedQuery`), frozen or trained;
    - `samples_override` = (proposal_0, proposal_1, nerf) replaces the
      per-ray sample schedule for the emitter query only; counts must be
      multiples of 8;
    - `mesh` and `data_axis`: the kernel query is split over the ranks by
      rows (shard_fused_query). Give them only where every rank calls the
      emitter with the same, replicated batch; rays that a sharded step
      has already split are the rank's own and need no collective.
    """
    if samples_override is not None:
        p0, p1, ns = samples_override
        if any(s % 8 != 0 for s in (p0, p1, ns)):
            raise ValueError(
                f"emitter sample counts must be multiples of 8, got {samples_override}"
            )
        model = model.with_samples((p0, p1), ns)
    device = model.device
    box = torch.as_tensor(object_aabb, dtype=torch.float32, device=device)
    fused_query = None
    if serves_kernel_query(model, use_fused):
        fused_query = make_mega_radiance_query(
            model, disable_box=tuple(tuple(float(x) for x in row) for row in box.tolist()),
            device=device,
        )
        if mesh is not None and data_axis is not None:
            fused_query = shard_fused_query(fused_query, mesh)

    def emitter_fn_of(params=None, camera_index=None, rot_id=None):
        p = named_params(model if params is None else params)
        if detach_nerf:
            p = {k: v.detach() for k, v in p.items()}

        def rays_of(o_w: torch.Tensor, d: torch.Tensor) -> RayBundle:
            n = o_w.shape[0]
            cam = id_column(0 if camera_index is None else camera_index, (n, 1), o_w.device)
            rays = RayBundle(
                origins=o_w,
                directions=d,
                pixel_area=torch.full((n, 1), 1e-4, device=o_w.device),
                nears=torch.zeros((n, 1), device=o_w.device),
                fars=torch.full((n, 1), far, device=o_w.device),
                camera_indices=cam,
            )
            rays = aabb_far_intersect_collider(rays, box, far=far)
            if rotater is not None and rot_id is not None:
                rid = id_column(rot_id, (n,), o_w.device)
                rays = rays.replace(origins=rotater.apply_points(rid, rays.origins),
                                    directions=rotater.apply_dirs(rid, rays.directions))
            return rays

        def model_query(rows: dict, params: tuple) -> tuple:
            out = torch.func.functional_call(
                model, dict(zip(p, params)), (rays_of(rows["origins"], rows["directions"]),),
                dict(train=False, hdr_radiance_only=True, disable_aabb=box, disable_aabb_on=True,
                     spacing_bins=rows.get("spacing_bins")),
                strict=False,
            )
            return out["rgb"], out["spacing_bins"]

        def emitter_fn(x_unit: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            o_w = coords.unit_to_world(x_unit, scene_scale)
            if fused_query is not None:
                return fused_query(p, rays_of(o_w, d), camera_index=camera_index)
            return _ChunkedQuery.apply(model_query, o_w, d, *p.values())

        return emitter_fn

    return emitter_fn_of


def fold_in(generator: torch.Generator, data: int) -> torch.Generator:
    """A new generator on `generator`'s device, seeded from its current
    state and `data` (the role of jax.random.fold_in): the same state and
    data give the same generator, and `generator` does not advance."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes()
                            + int(data).to_bytes(8, "little", signed=True)).digest()
    return torch.Generator(device=generator.device).manual_seed(int.from_bytes(digest[:8], "little") >> 1)


@dataclasses.dataclass
class NerfEmitterPipelineConfig:
    """The sdf-nerfacto method's pipeline settings."""

    takeover_step: int = 2000
    mi_opt_steps: int = 320
    # takeover step at which the running means replace the live volumes
    # (None: mi_opt_steps - 1; -1: never, and no means are tracked)
    load_mean_step: Optional[int] = None
    scene_scale: float = 1.0
    object_aabb: tuple = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
    guiding_type: str = "vmf"  # 'vmf' | 'env' | 'emitter_xml'
    proposal_rebuild_every: int = 10
    tsdf_init_res: int = 128
    tsdf_depth_downscale: int = 4
    no_update_nerf: bool = True  # the NeRF is frozen during the takeover
    batch_size: int = 4  # images per takeover step
    spp: int = 32
    # the aggregate estimator: with spp > spp_attached the primal is the
    # full-spp mean, rendered detached, and the gradient flows through
    # spp_attached samples; 0: exact gradients of every sample
    spp_attached: int = 16
    # (proposal_0, proposal_1, nerf) samples per ray of the emitter query
    # alone; None: the model's own schedule
    emitter_samples: Optional[tuple] = None
    # takeover step from which the running means accumulate (None: the
    # last 64 steps)
    mean_start: Optional[int] = None
    takeover_image_size: int = 64
    sdf_init: str = "tsdf"  # 'tsdf' (from the NeRF's depth) | 'sphere'
    env_path: Optional[str] = None  # the GT envmap of guiding_type='env'
    # False renders the emitter behind the object (synthetic scenes); True
    # leaves the background to the occlusion layers (real scenes)
    hide_emitters: bool = False
    # real captures: occluder and background layers rendered from the NeRF
    # once at takeover and composited into every takeover render
    use_occlusion: bool = False
    rotation_radius: float = 0.6  # the turntable sphere around the object
    # the integrator's MIS: 'one_sample' queries the emitter once per
    # camera ray; 'both' is deterministic MIS
    mis_mode: str = "one_sample"
    # silhouette gradients of the takeover's renders: 'soft' (soft
    # visibility and a mask loss) or 'warp' (the reparameterisation)
    reparam: str = "soft"
    warp_secondary: bool = False
    # distil the frozen NeRF emitter into the light-field cache at takeover
    # (serving/distill.py); the guiding rebuild keeps querying the NeRF
    distill_emitter: bool = False
    distill_steps: int = 2000


class NerfEmitterPipeline:
    """Sequences the two phases and owns their states: the NeRF's model,
    train state and optimizer, and after the takeover the SDF state, its
    optimizer and step, and the emitter."""

    def __init__(
        self,
        config: NerfEmitterPipelineConfig,
        model: NerfactoModel,
        train_config: TrainConfig,
        opt_config: SdfOptConfig,
        dataset: ImageDataset,
        mi_dataset: Optional[ImageDataset] = None,
        render_config: RenderConfig = RenderConfig(),
        rotater=None,
        mesh: Optional[Mesh] = None,
        data_axis: Optional[str] = None,
    ):
        self.config = config
        self.model = model
        self.device = model.device
        self.rotater = rotater
        # a mesh of one rank, or none, is the one-device pipeline
        self.mesh = mesh if mesh is not None and data_axis is not None and mesh.world_size > 1 else None
        self.data_axis = data_axis if self.mesh is not None else None
        self.train_config = dataclasses.replace(train_config, step_pretrain=config.takeover_step,
                                                rotation_radius=config.rotation_radius,
                                                data_axis=self.data_axis)
        self.opt_config = opt_config
        self.dataset = dataset
        self.mi_dataset = mi_dataset if mi_dataset is not None else dataset
        self.render_config = dataclasses.replace(render_config, mis_mode=config.mis_mode, reparam=config.reparam,
                                                 warp_secondary=config.warp_secondary)
        self.object_aabb = torch.as_tensor(config.object_aabb, dtype=torch.float32, device=self.device)
        self.guiding = VMFGuiding(rebuild_every=config.proposal_rebuild_every, scene_scale=config.scene_scale,
                                  mis_compensation=self.render_config.guiding_mis_compensation)
        self.data_dir = "."  # where guiding_type 'env' finds env.exr; the trainer sets it
        # the NeRF side
        self.nerf_state, self.nerf_tx = create_train_state(model, self.train_config, self.mesh)
        self.nerf_step_fn = make_train_step(model, self.train_config, self.nerf_tx, mesh=self.mesh, rotater=rotater)
        self.render_fn = make_render_fn(model, self.train_config, rotater=rotater,
                                        camera_rot_ids=dataset.rotation_ids, mesh=self.mesh,
                                        data_axis=self.data_axis)
        # a view on this rank alone (the viewer's, on rank 0)
        self._rank_render_fn = self.render_fn if self.mesh is None else make_render_fn(
            model, self.train_config, rotater=rotater, camera_rot_ids=dataset.rotation_ids)
        # held around every step, eval view and save by the trainer and
        # around every render by the viewer's threads (viewer/server.py);
        # first come, first served, so a render waits for one step at most
        self.lock = FairLock()
        # the SDF side, from the takeover on
        self.sdf_state: Optional[SdfOptState] = None
        # the learned denoiser, fitted on first use (fit_scene_denoiser)
        self._denoiser_params = None
        self._denoiser_config: Optional[DenoiserConfig] = None
        self.sdf_tx = None
        self.sdf_step_fn = None
        self.occlusion = None
        self.distill_fidelity = None
        # what serves views after the takeover: the NeRF's query, or the
        # scene's envmap (set again when the emitter is bound)
        self._serving_use_nerf = config.guiding_type == "vmf"
        self._emitter_fn_of = make_nerf_emitter_fn(model, config.scene_scale, self.object_aabb,
                                                   detach_nerf=config.no_update_nerf, rotater=rotater,
                                                   samples_override=config.emitter_samples)
        # the distillation's teacher: every rank asks it the same batch
        self._teacher_fn_of = self._emitter_fn_of if self.mesh is None else make_nerf_emitter_fn(
            model, config.scene_scale, self.object_aabb, detach_nerf=config.no_update_nerf, rotater=rotater,
            samples_override=config.emitter_samples, mesh=self.mesh, data_axis=self.data_axis)

    @property
    def _use_env(self) -> bool:
        return self.config.guiding_type in ("env", "emitter_xml")

    # ---- the NeRF phase

    def nerf_iteration(self, generator: torch.Generator) -> dict:
        return self.nerf_step_fn(self.nerf_state, self.dataset, generator)

    # ---- the takeover's start

    @torch.no_grad()
    def tsdf_init(self) -> SdfScene:
        """The initial scene: the NeRF's depth from the first 32 training
        cameras at 1/tsdf_depth_downscale of their size, the rays clipped
        to the object box (so the environment, the NeRF's fog shells
        included, cannot enter the fusion) and marked free where the
        in-box accumulation is 0.3 or less; fused at tsdf_init_res^3,
        resampled to the recipe's init_res. A fusion with no interior falls
        back to a sphere of radius 0.25."""
        cams = self.dataset.cameras
        d = self.config.tsdf_depth_downscale
        n_cams = min(len(cams), 32)
        small = Cameras(camera_to_worlds=cams.camera_to_worlds[:n_cams], fx=cams.fx[:n_cams] / d,
                        fy=cams.fy[:n_cams] / d, cx=cams.cx[:n_cams] / d, cy=cams.cy[:n_cams] / d,
                        width=cams.width // d, height=cams.height // d)
        obj_box = SceneBox(aabb=self.object_aabb, crop_mode=CropMode.NORMAL)
        depths = []
        for i in range(n_cams):
            out = self.render_fn(small, i, small.height, small.width, aabb_box=obj_box)
            depths.append(torch.where(out["accumulation"] > 0.3, out["depth"], 1e3))
        sdf = tsdf.tsdf_init_sdf(small, torch.stack(depths), res=self.config.tsdf_init_res,
                                 scene_scale=self.config.scene_scale, object_aabb=self.object_aabb)
        sdf = upsample_grid(sdf, self.opt_config.init_res)
        if float(sdf.min()) >= 0.0:
            print("tsdf_init: degenerate fusion, falling back to sphere init")
            sdf = sphere_sdf_grid(self.opt_config.init_res, radius=0.25, device=self.device)
        tex = (self.opt_config.tex_res,) * 3
        return SdfScene(sdf=sdf, albedo=torch.full(tex + (3,), 0.5, device=self.device),
                        roughness=torch.full(tex + (1,), 0.5, device=self.device),
                        bsdf_type=self.opt_config.bsdf_type, hide_emitters=self.config.hide_emitters)

    def _sphere_scene(self) -> SdfScene:
        """The start without a NeRF to fuse from: a sphere sized to the
        object box, so that not every pixel ray hits it (with every ray a
        hit the soft silhouette has no gradient and the blob cannot
        shrink)."""
        half = float(torch.min(self.object_aabb[1] - self.object_aabb[0])) * 0.5
        radius = min(0.45, max(0.05, 0.8 * half / (2.0 * self.config.scene_scale)))
        scene = SdfScene.create(sdf_res=self.opt_config.init_res, tex_res=self.opt_config.tex_res,
                                bsdf_type=self.opt_config.bsdf_type, init_radius=radius, device=self.device)
        return scene.replace(hide_emitters=self.config.hide_emitters)

    def _new_sdf_state(self, scene: SdfScene) -> None:
        self._lr_up_scale = {}
        self.sdf_tx = build_sdf_optimizer(self.opt_config)
        track_mean = self.config.load_mean_step != -1
        self.sdf_state = replicated(SdfOptState(step=0, scene=scene, opt_state=self.sdf_tx.init(scene),
                                                mean_params=init_mean_params(scene) if track_mean else None),
                                    self.mesh)

    def _bind_emitter(self, generator: torch.Generator) -> None:
        """The takeover's and the serving's emitter from the current NeRF:
        the NeRF's own query, or the cache distilled from it with the
        scene's guiding mixture (none with an envmap)."""
        emitter_fn = emitter_for_camera = None
        if not self._use_env:
            fn_of = self._maybe_distilled_fn_of(fold_in(generator, 7), guiding=self.sdf_state.scene.guiding)
            emitter_fn = fn_of(self.model)
            emitter_for_camera = lambda cam_idx, rot_id: fn_of(self.model, camera_index=cam_idx,  # noqa: E731
                                                               rot_id=rot_id)
        if self.config.use_occlusion:
            self._render_occlusion_layers()
        self._serving_use_nerf = emitter_fn is not None
        self._takeover_emitter_fn = emitter_fn
        self._takeover_emitter_for_camera = emitter_for_camera

    def begin_takeover(self, generator: torch.Generator, scene: Optional[SdfScene] = None) -> None:
        """Start the takeover: the scene (TSDF or sphere), the envmap or the
        guiding mixture, the emitter, the occlusion layers, the optimizer
        and the step."""
        if scene is None:
            scene = self.tsdf_init() if self.config.sdf_init == "tsdf" and not self._use_env else self._sphere_scene()
        if self._use_env:
            env = EnvGuiding(env_path=self.config.env_path).build_envmap(self.data_dir, device=self.device)
            scene = scene.replace(envmap=env, guiding=None)
        else:
            g_guide = fold_in(generator, 0)
            scene = self.build_emitter_proposal(g_guide, scene)
        self._new_sdf_state(scene)
        self._bind_emitter(generator)
        self._takeover_size = self.config.takeover_image_size
        self._takeover_spp = self.config.spp
        self._rebuild_sdf_step_fn()

    def _maybe_distilled_fn_of(self, generator: torch.Generator, guiding=None):
        """The emitter_fn_of the takeover serves from: the full query, or
        with distill_emitter the light-field student fit to it (its
        fidelity kept on `distill_fidelity`). `guiding` draws half of the
        fit's directions toward the light lobes."""
        if not self.config.distill_emitter:
            return self._emitter_fn_of
        n_rot = int(self.rotater.transforms.shape[0]) if self.rotater is not None else 1
        student, fidelity, _ = distill_emitter(
            generator, self.model, self._teacher_fn_of, scene_scale=self.config.scene_scale,
            object_aabb=self.object_aabb, num_cameras=int(self.model.num_cameras), rotater=self.rotater,
            n_rotations=n_rot, guiding=guiding, config=DistillConfig(steps=self.config.distill_steps),
            device=self.device)
        replicated(student, self.mesh)
        self.distill_fidelity = fidelity
        print(f"distilled emitter cache: relRMS(linear)={fidelity['relrms_linear']:.4f} "
              f"RMSE(log)={fidelity['rmse_log']:.4f}")
        return make_student_emitter_fn_of(student, scene_scale=self.config.scene_scale,
                                          object_aabb=self.object_aabb, rotater=self.rotater)

    def _render_occlusion_layers(self) -> None:
        """The occluder and background layers from the current NeRF at the
        takeover's render size."""
        cams = self.mi_dataset.cameras
        d = max(1, int(cams.height) // self.config.takeover_image_size)
        small = Cameras(camera_to_worlds=cams.camera_to_worlds, fx=cams.fx / d, fy=cams.fy / d, cx=cams.cx / d,
                        cy=cams.cy / d, width=cams.width // d, height=cams.height // d)
        self.occlusion = render_occlusion_layers(
            lambda c, i, aabb_box=None: self.render_fn(c, i, c.height, c.width, aabb_box=aabb_box),
            small, self.object_aabb)

    def begin_takeover_template(self, sdf_res: Optional[int] = None) -> None:
        """`sdf_state` as a restore template alone: the structure and shapes
        (a sphere at the stored grid resolution `sdf_res`, a zeroed guiding
        mixture), none of begin_takeover's work. The restore overwrites it;
        resume_takeover_bind then binds the emitter and the step."""
        scene = SdfScene.create(sdf_res=sdf_res or self.opt_config.init_res, tex_res=self.opt_config.tex_res,
                                bsdf_type=self.opt_config.bsdf_type, device=self.device)
        scene = scene.replace(hide_emitters=self.config.hide_emitters)
        if self._use_env:
            env = EnvGuiding(env_path=self.config.env_path).build_envmap(self.data_dir, device=self.device)
            scene = scene.replace(envmap=env, guiding=None)
        else:
            k = self.guiding.n_clusters
            scene = scene.replace(guiding=VMFMixture(positions=torch.zeros((k, 3), device=self.device),
                                                     weights=torch.full((k,), 1.0 / k, device=self.device),
                                                     stds=torch.full((k,), 0.5, device=self.device)))
        self._new_sdf_state(scene)

    def resume_takeover_bind(self, generator: torch.Generator) -> None:
        """After a restore: bind the emitter (re-distilled from the
        restored NeRF) and the occlusion layers, replay the render-size,
        spp and lr schedule up to the restored grid's resolution (each
        volume upsample, R -> 2R - 1, doubled the render size, halved spp
        from 512 pixels on and decayed the lr), and rebuild the step."""
        if self.sdf_state is None:
            raise RuntimeError("resume_takeover_bind needs a restored sdf_state")
        self._bind_emitter(generator)
        size, spp = self.config.takeover_image_size, self.config.spp
        res, r = int(self.sdf_state.scene.sdf.shape[0]), int(self.opt_config.init_res)
        cap = int(min(self.mi_dataset.cameras.height, self.mi_dataset.cameras.width))
        self._lr_up_scale = {}
        while r < res:
            r = r * 2 - 1
            size = min(size * 2, cap)
            if size >= 512 and spp > 1:
                spp = max(1, spp // 2)
            for v in self.opt_config.variables:
                if v.lr_decay_at_up != 1.0:
                    self._lr_up_scale[v.name] = self._lr_up_scale.get(v.name, 1.0) * v.lr_decay_at_up
        if self._lr_up_scale:
            self.sdf_tx = build_sdf_optimizer(self.opt_config, self._lr_up_scale)
        self._takeover_size, self._takeover_spp = size, spp
        self._rebuild_sdf_step_fn()

    def _apply_volume_upsample_lr_decay(self) -> None:
        """After a volume upsample: each variable's lr times its
        lr_decay_at_up (8x the voxels carry higher-frequency modes at the
        same step size), the optimizer rebuilt and its moments restarted."""
        decays = {v.name: v.lr_decay_at_up for v in self.opt_config.variables if v.lr_decay_at_up != 1.0}
        if not decays:
            return
        for name, d in decays.items():
            self._lr_up_scale[name] = self._lr_up_scale.get(name, 1.0) * d
        self.sdf_tx = build_sdf_optimizer(self.opt_config, self._lr_up_scale)
        self.sdf_state = self.sdf_state.replace(opt_state=self.sdf_tx.init(self.sdf_state.scene))
        print(f"volume upsample: lr scale -> {self._lr_up_scale}")
        self._rebuild_sdf_step_fn()

    def _rebuild_sdf_step_fn(self) -> None:
        """The takeover step at the current render size and spp."""
        mean_start = self.config.mean_start
        if mean_start is None:
            mean_start = max(0, self.config.mi_opt_steps - 64)
        spp = self._takeover_spp
        takeover = TakeoverConfig(
            spp=spp, spp_per_batch=min(TakeoverConfig.spp_per_batch, spp),
            # capped at the live spp, so that halving spp keeps the banded
            # aggregate path (exact when equal)
            spp_attached=min(self.config.spp_attached, spp) if self.config.spp_attached > 0 else 0,
            image_height=self._takeover_size, image_width=self._takeover_size,
            scene_scale=self.config.scene_scale, mean_start_step=mean_start)
        self.sdf_step_fn = make_sdf_train_step(
            self.opt_config, takeover, self.sdf_tx, emitter_fn=self._takeover_emitter_fn,
            render_config=self.render_config, emitter_for_camera=self._takeover_emitter_for_camera,
            rotater=self.rotater, camera_rot_ids=self.mi_dataset.rotation_ids,
            use_occlusion=self.occlusion is not None, mesh=self.mesh, data_axis=self.data_axis)

    def _maybe_upsample_render_res(self, mi_step: int) -> None:
        """Double the render size (up to the images') at the recipe's
        render_upsample_iter steps, halving spp from 512 pixels on."""
        if mi_step not in self.opt_config.render_upsample_iter:
            return
        cap = int(min(self.mi_dataset.cameras.height, self.mi_dataset.cameras.width))
        new_size = min(self._takeover_size * 2, cap)
        if new_size == self._takeover_size:
            return
        self._takeover_size = new_size
        if new_size >= 512 and self._takeover_spp > 1:
            self._takeover_spp = max(1, self._takeover_spp // 2)
        print(f"takeover render res -> {new_size}, spp {self._takeover_spp}")
        self._rebuild_sdf_step_fn()

    @profiler.span("takeover.guiding")
    def build_emitter_proposal(self, generator: torch.Generator, scene: SdfScene) -> SdfScene:
        """The scene with its vMF guiding mixture rebuilt from the current
        NeRF."""
        vmf = self.guiding.build(generator, self.model, self.dataset.cameras, object_aabb=self.object_aabb)
        return scene.replace(guiding=replicated(vmf, self.mesh))

    # ---- the takeover

    @profiler.span("takeover.step")
    def takeover_iteration(self, generator: torch.Generator, *, cam_idx: Optional[torch.Tensor] = None,
                           draws: Optional[list] = None) -> dict:
        """One takeover step: the schedule's render size, the guiding
        rebuild, batch_size cameras drawn without replacement (or
        `cam_idx`), the step (its random numbers from `generator`, or
        `draws`, a list of sdf_optimizer.ImageDraws), the host's schedule
        with the lr decay after a volume upsample, and at the load-mean
        step the swap to the running means."""
        if self.sdf_state is None:
            raise RuntimeError("call begin_takeover first")
        mi_step = int(self.sdf_state.step)
        self._maybe_upsample_render_res(mi_step)
        if not self._use_env and self.guiding.should_rebuild(mi_step):
            self.sdf_state = self.sdf_state.replace(scene=self.build_emitter_proposal(generator, self.sdf_state.scene))
        ds = self.mi_dataset
        if cam_idx is None:
            cam_idx = torch.randperm(ds.images.shape[0], generator=generator, device=self.device)[
                :self.config.batch_size]
        gt = ds.images[cam_idx]
        masks = ds.masks[cam_idx] if ds.masks is not None else torch.ones((*gt.shape[:3], 1), device=gt.device)
        occ = None
        if self.occlusion is not None:
            occ = (self.occlusion.occlusion_rgb[cam_idx], self.occlusion.occlusion_mask[cam_idx],
                   self.occlusion.background_rgb[cam_idx])
        with profiler.span("takeover.sdf_step"):
            self.sdf_state, metrics = self.sdf_step_fn(self.sdf_state, ds.cameras, cam_idx, gt, masks, generator,
                                                       draws=draws, occ_layers=occ)
        with profiler.span("takeover.post_step_host"):
            pre_shape = self.sdf_state.scene.sdf.shape
            self.sdf_state = post_step_host(self.sdf_state, self.opt_config, self.sdf_tx)
            if self.sdf_state.scene.sdf.shape != pre_shape:
                clear_march_graphs()  # the graphs of the replaced grid
                self._apply_volume_upsample_lr_decay()
            lm = self.config.load_mean_step
            if lm is None:
                lm = self.config.mi_opt_steps - 1
            if lm >= 0 and mi_step == lm:
                self.sdf_state = load_mean_parameters(self.sdf_state)
        return metrics

    # ---- serving

    def set_relight_emitter(self, emitter_path) -> None:
        """Relight: the serving emitter becomes the envmap image at
        `emitter_path`; the scene keeps its geometry and materials."""
        if self.sdf_state is None:
            raise RuntimeError("relighting needs the takeover's state")
        env = EmitterImageGuiding(emitter_path).build_envmap(device=self.device)
        self.sdf_state = self.sdf_state.replace(scene=self.sdf_state.scene.replace(envmap=env, guiding=None))
        self._serving_use_nerf = False

    @torch.no_grad()
    def render_camera_outputs(self, dataset: ImageDataset, cam_index: int, generator: torch.Generator,
                              spp: int = 64, spp_per_batch: int = 64, denoise=False, collective: bool = True) -> dict:
        """A view of `dataset`: before the takeover the NeRF's render, after
        it the SDF scene's, lit by the full NeRF query (not the distilled
        cache) unless an envmap relights it. spp is rendered in
        power-of-two batches of at most spp_per_batch (divide_spp), without
        the warp (serving needs no gradient). denoise True or 'bilateral':
        the joint bilateral filter; 'learned': the per-scene learned
        denoiser (renderer/learned_denoise.py), fitted on first use by
        fit_scene_denoiser from a generator seeded 17 and applied with the
        first spp batch's normal and depth. With a mesh each rank renders its
        rows of the pixel rays (the whole view's draws, cut to its rows) and
        the rows are gathered; collective=False renders the whole view on
        this rank alone (every rank must call the collective view)."""
        cams = dataset.cameras
        if self.sdf_state is None:
            render_fn = self.render_fn if collective else self._rank_render_fn
            return render_fn(cams, cam_index, cams.height, cams.width)
        h, w = cams.height, cams.width
        mesh = self.mesh if collective else None
        rot_ids = dataset.rotation_ids
        rid = rot_ids[cam_index] if (self.rotater is not None and rot_ids is not None) else None
        emitter = (self._emitter_fn_of(self.model, camera_index=cam_index, rot_id=rid)
                   if self._serving_use_nerf else None)
        o, d = camera_rays_in_render_space(cams, cam_index, h, w, self.config.scene_scale, rotater=self.rotater,
                                           rot_id=rid)
        serve_cfg = dataclasses.replace(self.render_config, reparam="soft")
        scene, n = self.sdf_state.scene, h * w
        o_l, d_l = data_sharded(o, mesh), data_sharded(d, mesh)
        rgb, first = None, None
        for chunk_spp in divide_spp(spp, max(1, spp_per_batch)):
            draws = None
            if mesh is not None:
                draws = draw_direct(scene, n, generator, o.device, lead=(chunk_spp,)).map(
                    lambda t: shard_axis(t, mesh, 1))
            out = render_spp(scene, o_l, d_l, chunk_spp, generator, draws=draws, emitter_fn=emitter,
                             config=serve_cfg, remat=False)
            if mesh is not None:
                out = {k: gather_rows(out[k], mesh, n) for k in ("rgb", "depth", "normal", "soft_mask")}
            first = out if first is None else first
            part = out["rgb"] * (chunk_spp / spp)
            rgb = part if rgb is None else rgb + part
        rgb = rgb.reshape(h, w, 3)
        depth, normal = first["depth"].reshape(h, w, 1), first["normal"].reshape(h, w, 3)
        if denoise == "learned":
            if self._denoiser_params is None:
                self.fit_scene_denoiser(torch.Generator(device=self.device).manual_seed(17), dataset)
            rgb = apply_denoiser(self._denoiser_params, rgb, normal, depth, self._denoiser_config)
        elif denoise:
            rgb = bilateral_denoise(rgb, normal=normal, depth=depth)
        return {"rgb": rgb, "depth": depth, "normal": normal, "accumulation": first["soft_mask"].reshape(h, w, 1)}

    def fit_scene_denoiser(self, generator: torch.Generator, dataset: ImageDataset, n_views: int = 3,
                           fit_spp: int = 8, config: Optional[DenoiserConfig] = None) -> float:
        """Noise2noise fit of the per-scene learned denoiser: each of n_views
        training views rendered twice at fit_spp (render_camera_outputs
        without denoising) on two independent generators folded in from
        `generator`, the two renders each other's targets, so no clean
        reference is needed. Caches the predictor and its config on the
        pipeline; returns the final fit loss."""
        config = config or DenoiserConfig()
        n_cams = dataset.cameras.camera_to_worlds.shape[0]
        pairs = []
        for i in range(n_views):
            cam = int(i * max(1, n_cams // n_views)) % n_cams
            a, b = (self.render_camera_outputs(dataset, cam, fold_in(generator, 2 * i + j), spp=fit_spp,
                                               denoise=False) for j in (0, 1))
            pairs.append((a["rgb"], b["rgb"], a["normal"], a["depth"]))
        self._denoiser_params, loss = fit_denoiser(fold_in(generator, 2 * n_views), pairs, config)
        replicated(self._denoiser_params, self.mesh)
        self._denoiser_config = config
        return loss

    def get_average_eval_image_metrics(self, dataset: ImageDataset, generator: torch.Generator, spp: int = 64,
                                       get_std: bool = False) -> dict:
        """PSNR, SSIM, MAPE and the perceptual distance averaged over the
        split (with get_std, their standard deviations too)."""
        all_m: dict[str, list] = {}
        for i in range(dataset.images.shape[0]):
            out = self.render_camera_outputs(dataset, i, generator, spp=spp)
            for name, v in eval_image_metrics(out["rgb"], dataset.images[i], is_hdr=dataset.is_hdr).items():
                all_m.setdefault(name, []).append(v)
        result = {name: float(torch.tensor(v).mean()) for name, v in all_m.items()}
        if get_std:
            # jnp.std's population deviation
            result |= {f"{name}_std": float(torch.tensor(v).std(correction=0)) for name, v in all_m.items()}
        return result

    # ---- the two phases

    def train_iteration(self, step: int, generator: torch.Generator) -> dict:
        """One step of the two-phase schedule."""
        if step < self.config.takeover_step:
            return self.nerf_iteration(generator)
        if self.sdf_state is None:
            self.begin_takeover(generator)
        return self.takeover_iteration(generator)
