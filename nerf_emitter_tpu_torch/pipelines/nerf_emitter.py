"""The NeRF-as-emitter query closure (port of `make_nerf_emitter_fn` in
nerf_emitter_tpu/pipelines/nerf_emitter.py) and the gate that picks what
serves it. The two-phase pipeline itself is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cameras.rays import RayBundle
from ..models.nerfacto import NerfactoModel
from ..ops.colliders import aabb_far_intersect_collider
from ..ops.fused_field import named_params
from ..utils import coords


def id_column(value, shape, device) -> torch.Tensor:
    """A long tensor of `shape` holding `value`, an int or a tensor (for
    example a device-side draw). An int is filled in on the device: a
    host-to-device copy of it would synchronise the stream on every call."""
    if isinstance(value, torch.Tensor):
        return value.to(device).long().expand(shape)
    return torch.full(shape, int(value), dtype=torch.long, device=device)


def serves_kernel_query(model, use_fused: bool) -> bool:
    """Whether the emitter query runs on the kernel query (K5, or K3 + K4)
    rather than the model's forward: only for `implementation == "freq"`
    with the fake contraction (what the kernels compute) on a model on
    CUDA, and only when asked (`use_fused`). The reference gates the same
    way (freq on its TPU backend). The decision reads the configuration
    alone; a kernel that then fails to build or launch raises."""
    return (
        bool(use_fused)
        and model.implementation == "freq"
        and bool(model.use_fake_contraction)
        and model.device.type == "cuda"
    )


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
      dict of its parameters; `detach_nerf` treats the radiance as a
      constant for the caller's backward (the NeRF gets no gradient);
    - `camera_index` picks the appearance embedding;
    - `rotater` + `rot_id` map the canonical object-frame query ray into
      the world (light) frame for turntable captures, after the collider
      (the object box lives in the canonical frame; near and far are
      distances along the ray, which the rigid rotation keeps);
    - `use_fused` serves the query through the kernel query
      (ops/mega_query.py: K5, or K3 + K4 under
      NERF_EMITTER_MEGA_PIPELINED=0, read when this is called) where
      `serves_kernel_query` says so; otherwise the model's own forward
      serves it;
    - `samples_override` = (proposal_0, proposal_1, nerf) replaces the
      per-ray sample schedule for the emitter query only; counts must be
      multiples of 8.

    The multi-device mesh path is a later slice.
    """
    if mesh is not None or data_axis is not None:
        raise NotImplementedError("the multi-device query is not ported yet (ROADMAP.md, Queue 1 item 7)")
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
        from ..ops.mega_query import make_mega_radiance_query

        fused_query = make_mega_radiance_query(
            model, disable_box=tuple(tuple(float(x) for x in row) for row in box.tolist()),
            device=device,
        )

    def emitter_fn_of(params=None, camera_index=None, rot_id=None):
        p = named_params(model if params is None else params)
        if detach_nerf:
            p = {k: v.detach() for k, v in p.items()}

        def emitter_fn(x_unit: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
            o_w = coords.unit_to_world(x_unit, scene_scale)
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
            if fused_query is not None:
                return fused_query(p, rays, camera_index=camera_index)
            out = torch.func.functional_call(
                model, p, (rays,),
                dict(train=False, hdr_radiance_only=True, disable_aabb=box, disable_aabb_on=True),
                strict=False,
            )
            return out["rgb"]

        return emitter_fn

    return emitter_fn_of
