"""The NeRF-as-emitter query closure (port of `make_nerf_emitter_fn` in
nerf_emitter_tpu/pipelines/nerf_emitter.py). The two-phase pipeline itself
is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cameras.rays import RayBundle
from ..models.nerfacto import NerfactoModel
from ..ops.colliders import aabb_far_intersect_collider
from ..ops.fused_field import named_params
from ..utils import coords


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
    - `use_fused` serves the query through the kernel query
      (ops/mega_query.py: K5, or K3 + K4 under
      NERF_EMITTER_MEGA_PIPELINED=0, read when this is called) when the
      model lives on CUDA; on the CPU the model's own forward serves it
      (the reference's TPU-backend gate);
    - `samples_override` = (proposal_0, proposal_1, nerf) replaces the
      per-ray sample schedule for the emitter query only; counts must be
      multiples of 8.

    The rotater and the multi-device mesh paths are later slices.
    """
    if rotater is not None:
        raise NotImplementedError("the rotater path is not ported yet (ROADMAP.md, Queue 1 item 1)")
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
    if use_fused and device.type == "cuda":
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
            cam = torch.full((n, 1), 0 if camera_index is None else int(camera_index),
                             dtype=torch.long, device=o_w.device)
            rays = RayBundle(
                origins=o_w,
                directions=d,
                pixel_area=torch.full((n, 1), 1e-4, device=o_w.device),
                nears=torch.zeros((n, 1), device=o_w.device),
                fars=torch.full((n, 1), far, device=o_w.device),
                camera_indices=cam,
            )
            rays = aabb_far_intersect_collider(rays, box, far=far)
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
