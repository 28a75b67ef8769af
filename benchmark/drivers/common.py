"""What the drivers share: the inputs from the seed, the NeRF's
constructor arguments and the check of its widths, and the reference's
model."""

from __future__ import annotations

import hashlib

import torch
from torch import nn

from .. import roofline, scene
from ..reference.models.nerfacto import NerfactoModel as RefModel


def derive(seed: int, tag: str) -> int:
    """A seed for one use (`tag`) of the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()[:8], "little") >> 2


def model_kwargs(config: dict, num_cameras: int) -> dict:
    """The NeRF's constructor arguments (the port's and the reference's
    NerfactoModel take the same) from the configuration: every width the
    constructor takes (the hash field's table size and finest resolution
    where the field is `hash`). The widths it fixes itself are held
    against the configuration by `check_model`."""
    m = config["model"]
    s = m["aabb_scale"]
    kw = dict(aabb=((-s, -s, -s), (s, s, s)), hdr=m["hdr"], num_nerf_samples=m["num_nerf_samples"],
              num_proposal_samples=tuple(m["num_proposal_samples"]), num_cameras=num_cameras,
              appearance_embedding_dim=m["appearance_embedding_dim"], background_color=m["background_color"],
              use_fake_contraction=m["use_fake_contraction"], implementation=m["implementation"])
    if m["implementation"] == "hash":
        kw.update(log2_hashmap_size=m["log2_hashmap_size"], max_res=m["max_res"])
    return kw


def check_model(model, config: dict) -> None:
    """Raise ValueError where the built NerfactoModel's Linear shapes (in,
    out) or hash table rows differ from what the configuration's widths
    imply (`roofline`), so that the yardstick never describes another model
    than the one that runs."""
    def built(module):
        return [(m.in_features, m.out_features) for m in module.modules() if isinstance(m, nn.Linear)]

    def rows(module):
        table = getattr(module, "hash_table", None)
        return None if table is None else table.shape[0]

    def layers(dims):
        return list(zip(dims[:-1], dims[1:]))

    d = roofline.nerf_mlp_dims(config)
    props = model.proposal_networks
    got = {"proposals": [built(p.mlp) for p in props], "base": built(model.field.base_mlp),
           "head": built(model.field.head_mlp),
           "tables": {"proposals": [rows(p) for p in props], "field": rows(model.field)}}
    want = {"proposals": [layers(p) for p in d["proposals"]], "base": layers(d["base"]), "head": layers(d["head"]),
            "tables": roofline.table_rows(config)}
    diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if diff:
        raise ValueError(f"the built NeRF differs from the configuration's widths (built, configured): {diff}")


def weight_shapes(config: dict, num_cameras: int) -> dict:
    """The NeRF's parameter shapes, from the reference's model (built on the
    meta device, so nothing is allocated; its widths checked against the
    configuration's)."""
    kw = model_kwargs(config, num_cameras)
    model = RefModel(kw.pop("aabb"), device="meta", **kw)
    check_model(model, config)
    return {k: tuple(v.shape) for k, v in model.named_parameters()}


def ref_model(config: dict, num_cameras: int, weights: dict, device, precision: str = "bf16"):
    """The reference's NeRF with the run's weights, in `precision`."""
    from ..reference.pipeline import set_precision

    kw = model_kwargs(config, num_cameras)
    model = RefModel(kw.pop("aabb"), device=device, **kw)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(weights[k])
    set_precision(model, precision)
    return model


def views(traffic: dict, seed: int, device, scene_scale: float, masks: bool) -> dict:
    """The traffic's views: cameras (dataparser tensors), images, masks
    (None unless asked). The poses come from the traffic's `pose_seed`
    where it gives one (every run then sees the same views, so the seed
    does not change the work), else from the run's seed."""
    n, size, radius = traffic["views"], traffic["image_size"], traffic["radius"]
    pose_seed = traffic.get("pose_seed", derive(seed, "poses"))
    poses = (scene.ring_poses if traffic["poses"] == "ring" else scene.random_poses)(n, radius, pose_seed)
    focal = scene.synthetic_focal(size)
    images, mask = scene.render_views(poses, size, size, focal, device)
    return {"cams": scene.camera_tensors(poses, focal, size, size, scene_scale, device), "images": images,
            "masks": mask if masks else None}


def cuda_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ref_guiding(config: dict, settings, inputs: dict, weights: dict, gen_seed: int, device, precision: str):
    """The reference's guiding build from the run's NeRF and the takeover's
    generator (the guiding's own, `fold_in(generator, 0)`, as at the
    port's begin_takeover): (points (N, 3) in render space, their weights,
    (means, mixture weights, stds))."""
    from ..reference.cameras.cameras import Cameras
    from ..reference.guiding.gmm import fit_spherical_gmm
    from ..reference.guiding.light_pc import compensate_pc, extract_light_point_cloud
    from ..reference.guiding.path_guiding import VMFGuiding
    from ..reference.pipeline import fold_in, tf32_off
    from ..reference.utils import coords

    with tf32_off():
        model = ref_model(config, inputs["images"].shape[0], weights, device, precision)
        vg = VMFGuiding(scene_scale=settings.scene_scale)
        pc = extract_light_point_cloud(model, Cameras(**inputs["cams"]), object_aabb=settings.object_aabb,
                                       downscale=vg.downscale)
        pts, w = compensate_pc(pc["points"], pc["luminance"], vg.max_points)
        pts = coords.world_to_unit(pts, settings.scene_scale)
        g = fold_in(torch.Generator(device=device).manual_seed(gen_seed), 0)
        means, pis, stds = fit_spherical_gmm(g, pts, w, vg.n_clusters)
    return pts, w, (means, pis, torch.clamp(stds, min=1e-3))
