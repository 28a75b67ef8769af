"""Distilled light-field emitter cache (port of
nerf_emitter_tpu/serving/distill.py): the whole emitter query in one MLP
evaluation per ray.

The takeover freezes the NeRF, so every escaped ray is answered by a fixed
function radiance(ray). A student MLP is fit to it once, with the kernel
emitter query (K5) as its teacher:

    raw = MLP(freq(exit_pos), freq(dir), appearance_emb)     # HDR log space
    radiance = max(exp(raw) - EPS_LOG, 0)

- exit_pos = origin + near dir after the far-intersect collider and the
  turntable rotation, the canonicalisation of `make_nerf_emitter_fn`, so
  two query rays on one line map to one input;
- the appearance embedding is looked up in the frozen NeRF's table and
  appended, so one student serves every camera;
- training data are fresh teacher queries every step: half of the
  directions uniform on the sphere, half from the vMF guiding mixture when
  one is given (the bright lobes that MIS weights most).

The student's layers are flax `Dense(dtype=bfloat16)`: operands rounded to
bf16, a bf16 product (f32 accumulation, one rounding), then the bias added
in bf16, as two separate steps. They are plain products, as the
reference's are plain XLA.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..cameras.rays import RayBundle
from ..fields.encodings import nerf_encode
from ..fields.mlp import MLP
from ..ops.colliders import aabb_far_intersect_collider
from ..ops.fused_field import named_params
from ..utils import coords
from ..utils.device import id_column, resolve_device

EPS_LOG = 1e-3  # log-space fit floor; subtracted back when serving


class EmitterLightField(MLP):
    """Student MLP over (canonical exit point, direction, appearance
    embedding) -> raw log-radiance (3,). Layers `hidden_0` ..
    `hidden_{depth-1}` and `out`, the flax module's names, so the bridge
    maps them; initial weights from `generator` where one is given."""

    def __init__(self, hidden: int = 256, depth: int = 6, pos_freqs: int = 6, dir_freqs: int = 4,
                 pos_center=(0.0, 0.0, 0.0), pos_scale: float = 1.0, emb_dim: int = 0, device=None,
                 generator: torch.Generator | None = None):
        in_dim = 3 * (2 * pos_freqs + 1) + 3 * (2 * dir_freqs + 1) + emb_dim
        super().__init__(in_dim, 3, num_layers=depth + 1, layer_width=hidden, device=device,
                         generator=generator)
        self.pos_freqs, self.dir_freqs = pos_freqs, dir_freqs
        self.register_buffer("pos_center", torch.tensor(pos_center, dtype=torch.float32, device=device))
        self.pos_scale = float(pos_scale)

    def forward(self, pos: torch.Tensor, d: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        p = (pos - self.pos_center) / self.pos_scale
        # octaves 2^0 .. 2^(F-1): the inputs are normalised to ~[-1, 1]
        h = torch.cat([
            nerf_encode(p, self.pos_freqs, max_freq_exp=self.pos_freqs - 1.0),
            nerf_encode(d, self.dir_freqs, max_freq_exp=self.dir_freqs - 1.0),
            emb,
        ], dim=-1).to(torch.bfloat16)
        layers = self.layers()
        for i, lin in enumerate(layers):
            h = F.linear(h, lin.weight.to(torch.bfloat16)) + lin.bias.to(torch.bfloat16)
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h.float()


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    steps: int = 2000
    batch: int = 1 << 14
    lr: float = 2e-3
    hidden: int = 256
    depth: int = 6
    holdout_batches: int = 8  # fidelity measured after the fit
    # share of training directions drawn from the vMF guiding mixture
    # (when one is given): MIS weights the render integrand by exactly these
    # lobes, so they need a lower relative cache error
    guided_frac: float = 0.5


def _appearance_emb(nerf, camera_index, n: int, device) -> torch.Tensor:
    """The NeRF's appearance vector of `camera_index` (an int or a 0-d
    tensor) repeated n times, (n, E); (n, 0) on `device` for a NeRF without
    one. `nerf` is the model or its {name: tensor} parameters."""
    table = named_params(nerf).get("field.appearance_embedding.weight")
    if table is None:
        return torch.zeros((n, 0), dtype=torch.float32, device=device)
    cam = camera_index.long() if isinstance(camera_index, torch.Tensor) else int(camera_index)
    return table[cam][None, :].expand(n, table.shape[1])


def _canonical_inputs(x_unit, d, *, scene_scale: float, object_aabb, far: float, rotater, rot_id):
    """make_nerf_emitter_fn's canonicalisation: unit -> world, the
    far-intersect collider in the canonical frame, then the turntable
    rotation. Returns (exit point (n, 3), direction (n, 3)), world frame."""
    o_w = coords.unit_to_world(x_unit, scene_scale)
    n, dev = o_w.shape[0], o_w.device
    rays = RayBundle(
        origins=o_w, directions=d, pixel_area=torch.full((n, 1), 1e-4, device=dev),
        nears=torch.zeros((n, 1), device=dev), fars=torch.full((n, 1), far, device=dev),
        camera_indices=torch.zeros((n, 1), dtype=torch.long, device=dev),
    )
    box = torch.as_tensor(object_aabb, dtype=torch.float32, device=dev)
    rays = aabb_far_intersect_collider(rays, box, far=far)
    o, dd = rays.origins, rays.directions
    if rotater is not None and rot_id is not None:
        rid = id_column(rot_id, (n,), dev)
        o = rotater.apply_points(rid, o)
        dd = rotater.apply_dirs(rid, dd)
    return o + rays.nears * dd, dd


def make_student_emitter_fn_of(student: EmitterLightField, *, scene_scale: float, object_aabb,
                               far: float = 1e3, rotater=None):
    """emitter_fn_of(nerf, camera_index=None, rot_id=None) -> emitter_fn(x_unit,
    d) -> radiance (n, 3), the make_nerf_emitter_fn contract served by the
    student. `nerf` (the model or its parameters) gives only the
    appearance embedding. The student's weights and the NeRF's parameters
    are detached (no parameter gradients); the geometry gradient with
    respect to x_unit and d flows."""
    sp = {k: v.detach() for k, v in student.named_parameters()}
    box = torch.as_tensor(object_aabb, dtype=torch.float32, device=student.pos_center.device)

    def emitter_fn_of(nerf, camera_index=None, rot_id=None):
        p = {k: v.detach() for k, v in named_params(nerf).items()}

        def emitter_fn(x_unit: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            pos, dd = _canonical_inputs(x_unit, d, scene_scale=scene_scale, object_aabb=box, far=far,
                                        rotater=rotater, rot_id=rot_id)
            emb = _appearance_emb(p, 0 if camera_index is None else camera_index, pos.shape[0],
                                  pos.device)
            raw = torch.func.functional_call(student, sp, (pos, dd, emb), strict=False)
            return torch.clamp(torch.exp(raw) - EPS_LOG, min=0.0)

        return emitter_fn

    return emitter_fn_of


def cosine_decay(steps: int):
    """optax.cosine_decay_schedule(1, steps) as a LambdaLR factor: the
    update of step k uses lr 0.5 (1 + cos(pi min(k, steps) / steps))."""
    steps = max(int(steps), 1)
    return lambda k: 0.5 * (1.0 + math.cos(math.pi * min(k, steps) / steps))


def make_optimizer(params, lr: float, steps: int):
    """optax.adam(optax.cosine_decay_schedule(lr, steps)): Adam with beta
    (0.9, 0.999), eps 1e-8, and its schedule; call `sched.step()` after
    each `opt.step()`."""
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(steps))


def distill_emitter(
    generator: torch.Generator,
    nerf,
    teacher_emitter_fn_of,
    *,
    scene_scale: float,
    object_aabb,
    num_cameras: int,
    far: float = 1e3,
    rotater=None,
    n_rotations: int = 1,
    guiding=None,
    config: DistillConfig = DistillConfig(),
    device=None,
):
    """Fit the light-field student to the frozen teacher.

    teacher_emitter_fn_of is a full-path emitter_fn_of
    (`make_nerf_emitter_fn(...)`), called with `nerf` (the model or its
    parameters), a random camera and a random rotation id every step, under
    `torch.no_grad()`. Query origins are uniform over the object box in
    unit coordinates, directions uniform on the sphere, and with `guiding`
    (a `VMFMixture`) a `config.guided_frac` share of them from the
    mixture. `generator` draws everything, the student's initial weights
    too, and must live on `device` (None: CUDA), where the fit runs.

    Returns (student, fidelity, losses): the student frozen
    (requires_grad off); fidelity holds the held-out
    linear-space relative RMS (`relrms_linear`), the log-space RMSE
    (`rmse_log`) and the last step's loss (`final_fit_loss`); losses (steps,)
    every step's loss."""
    dev = resolve_device(device)
    box = torch.as_tensor(object_aabb, dtype=torch.float32, device=dev)
    lo_u, hi_u = coords.world_to_unit(box[0], scene_scale), coords.world_to_unit(box[1], scene_scale)
    center = (box[0] + box[1]) / 2.0
    half_diag = float(torch.linalg.norm((box[1] - box[0]) / 2.0))
    emb_dim = _appearance_emb(nerf, 0, 1, dev).shape[1]
    student = EmitterLightField(
        hidden=config.hidden, depth=config.depth, pos_center=tuple(float(c) for c in center),
        pos_scale=max(half_diag * 1.5, 1e-3), emb_dim=emb_dim, device=dev, generator=generator,
    )
    b = config.batch

    def sample_batch():
        x_unit = lo_u + (hi_u - lo_u) * torch.rand((b, 3), generator=generator, device=dev)
        d = torch.randn((b, 3), generator=generator, device=dev)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        if guiding is not None and config.guided_frac > 0.0:
            # x_unit is the frame the integrator hands both guiding.sample
            # and emitter_fn
            d_g, _ = guiding.sample(x_unit, generator)
            use_g = torch.rand((b, 1), generator=generator, device=dev) < config.guided_frac
            d = torch.where(use_g, d_g, d)
        cam = torch.randint(0, max(num_cameras, 1), (), generator=generator, device=dev)
        rid = torch.randint(0, max(n_rotations, 1), (), generator=generator, device=dev)
        return x_unit, d, cam, rid

    def teacher_student(x_unit, d, cam, rid):
        rot = rid if rotater is not None else None
        with torch.no_grad():
            target = teacher_emitter_fn_of(nerf, camera_index=cam, rot_id=rot)(x_unit, d)
            target = torch.log(torch.clamp(target, min=0.0) + EPS_LOG)
        pos, dd = _canonical_inputs(x_unit, d, scene_scale=scene_scale, object_aabb=box, far=far,
                                    rotater=rotater, rot_id=rot)
        return student(pos, dd, _appearance_emb(nerf, cam, b, dev).detach()), target

    opt, sched = make_optimizer(student.parameters(), config.lr, config.steps)
    losses = []
    with torch.enable_grad():  # the fit trains whatever the caller's grad mode
        for _ in range(config.steps):
            raw, target = teacher_student(*sample_batch())
            loss = torch.mean((raw - target) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
    opt.zero_grad(set_to_none=True)
    student.requires_grad_(False)  # fit once; served frozen

    rels, logs = [], []
    with torch.no_grad():
        for _ in range(config.holdout_batches):
            raw, target = teacher_student(*sample_batch())
            pred_lin = torch.clamp(torch.exp(raw) - EPS_LOG, min=0.0)
            t_lin = torch.clamp(torch.exp(target) - EPS_LOG, min=0.0)
            rels.append(torch.mean(((pred_lin - t_lin) / (t_lin + 1e-2)) ** 2))
            logs.append(torch.mean((raw - target) ** 2))
    losses = torch.stack(losses) if losses else torch.zeros(0, device=dev)
    fidelity = {
        "relrms_linear": float(torch.sqrt(torch.mean(torch.stack(rels)))),
        "rmse_log": float(torch.sqrt(torch.mean(torch.stack(logs)))),
        "final_fit_loss": float(losses[-1]) if len(losses) else float("nan"),
    }
    return student, fidelity, losses
