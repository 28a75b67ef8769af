"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's kernels from nerf_emitter_tpu_torch/csrc with nvcc, holds
each kernel against its plain PyTorch twin at the shapes its path gives it
(and at part-filled sizes), runs the wgmma field MLP of K2, K4 and K5 alone
(held layer by layer, timed per layer kind beside a bf16 torch.matmul
chain), answers 2^16 escaped emitter rays at the full width of the
sdf-nerfacto `freq` model (random weights from --seed) through the kernel
query (K5), through K3 then K4 on K3's bins and through the staged query
(K1 + K2), checks the answers against the model's plain forward, holds
the vjp kernel (the query's backward for a frozen NeRF) against its plain
version at 2^16 rays and at a part-filled group, times
a backward pass through the query at 2^14 rays by both of its routes, the
NeRF's parameters trained and frozen (each gradient held against the
model forward's), runs the three profiling entry points at
their own shapes, then the takeover's emitter as sdf-nerfacto ships it: K5
at the gated and an overridden sample schedule, the `hash` model at
nerfacto's published widths through the hash-grid kernel (K7, each
launcher and the model's training step against its plain twin; its
pretraining; its emitter's query and frozen backward), the
turntable, the vMF guiding build, the distillation of
the light-field cache with K5 as its teacher, and the distilled path; then
the SDF renderer (one view on the card against the CPU, and lit by K5
against the model forward), takeover steps at sdf-nerfacto's width lit
by the distilled cache (64^2, 128^2 through the first upsample, 256^2 on
253^3) and one lit by K5, and the JAX suite's shape-recovery run; then
NeRF pretraining as sdf-nerfacto runs it (the `freq` model at full width,
2^14 rays a batch, its losses, schedule and per-group Adam) on a synthetic
scene of 64 views at 256^2, with a held-out view rendered before and after,
and the trained field served through K5 and K3 + K4; then the whole method
through its train CLI on that scene (pretraining, the TSDF init, the
guiding, the cache distilled with K5 as its teacher, takeover steps, an
eval view lit by K5, checkpoints, and a resumed run); then the end-task
tools as round 5's protocol drives them, cut (gen_data's scene and its
relit twin, a short sdf-nerfacto run lit by K5, eval, every render
subcommand, the exporter and chamfer); then the learned denoiser fitted on
that run's K5-lit renders and held against the CPU, and the texture,
mesh-to-SDF and forward-gradient tools against the CPU; then the web
viewer beside a run of the train CLI (renders in every mode, pause,
resume and stop, the stopped run's checkpoint rendering the viewer's last
view again); then training across ranks on the one card (two gloo ranks
against one: the NeRF step, a K5-lit takeover step, the emitter query;
the train CLI in two processes and a one-rank NCCL world). Every phase
prints one JSON line; any failure raises and the script exits non-zero.
The last line is {"ok": true, "device": {...}}.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
OBJECT_BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
SAMPLES = (256, 96)
NERF_SAMPLES = 48
RAYS = 1 << 16  # escaped rays per emitter query, a multiple of the 128-ray tile
CHECK_RAYS = 4096  # rays held against the model forward
BACKWARD_RAYS = 1 << 14  # rays differentiated (the field twin's saved activations grow with them)
ODD_RAYS = 1003  # leaves a part-filled group in K3, K4 and K5, and part-filled passes in K1 and K2
GUIDE_CAMERAS, GUIDE_RES = 64, 256  # the light probes' ring: 64 x (256/4)^2 = 262,144 rays
TRAIN_VIEWS, TRAIN_RES = 64, 256  # the pretraining scene: 64 x 256^2 HDR pixels, ~50 MB on the card
TRAIN_RAYS = 1 << 14  # sdf-nerfacto's rays per batch
TRAIN_STEPS = 100
RENDER_RES, RENDER_SPP = 64, 4  # the render phase's view
TAKEOVER_RECIPE = "diffuse-12-relativel1-hqq"
# the port's kernels' entry functions (csrc/*.cu), as the profiler names them
KERNEL_ENTRIES = ("density_kernel", "field_kernel", "proposal_kernel", "field_composite_kernel",
                  "mega_pipeline_kernel", "field_mlp_kernel", "resample_kernel", "field_composite_vjp_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close(a: torch.Tensor, b: torch.Tensor, rtol: float, atol: float) -> dict:
    """Errors of a against the reference b, the share of its elements
    within atol + rtol |b|, and whether all of them are."""
    a, b = a.detach().float(), b.detach().float()
    err = (a - b).abs()
    inside = err <= atol + rtol * b.abs()
    ok = bool(torch.isfinite(a).all()) and bool(inside.all())
    return dict(max_abs_err=float(err.max()), max_rel_err=float((err / b.abs().clamp(min=atol)).max()),
                rtol=rtol, atol=atol, share_within=float(inside.float().mean()), within=ok)


def vectors_close(a: torch.Tensor, b: torch.Tensor, rel_l2: float, cos: float) -> dict:
    """Relative L2 error of a against the reference b and their cosine,
    each against its bar."""
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    err = float((a - b).norm() / b.norm().clamp(min=1e-30))
    c = float(a @ b / (a.norm() * b.norm()).clamp(min=1e-30))
    ok = bool(torch.isfinite(a).all()) and err <= rel_l2 and c >= cos
    return dict(rel_l2=err, rel_l2_bar=rel_l2, cos=c, cos_bar=cos, within=ok, max_abs_err=float((a - b).abs().max()))


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The larger of the operations' time (bf16 tensor-core flops at their
    peak) and the bytes' time."""
    t_ops = flops / H100_BF16_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ptxas_of(report: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes that ptxas reported for the
    entry function whose name contains `kernel`, and the count of ptxas's
    C7519 warnings (a `warpgroup.arrive` it injected) in that function."""
    out, inside = {"c7519": sum("C7519" in ln and kernel in ln for ln in report.splitlines())}, False
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            inside = kernel in ln
        elif inside and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out.update(stack_frame=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif inside and "Used" in ln and "registers" in ln:
            out["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def mlp_macs(ws) -> int:
    """Multiply-adds per sample of an MLP given its (in, out) weights."""
    return sum(w.shape[0] * w.shape[1] for w in ws)


def emitter_rays(n: int, seed: int, device):
    """x_unit uniform in [0.35, 0.65]^3 (around the object box), d uniform
    on the sphere."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = 0.35 + 0.3 * torch.rand((n, 3), generator=g)
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    return x.to(device), d.to(device)


def ring_cameras(count: int, res: int, device, focal: float | None = None):
    """`count` perspective cameras (res^2 pixels, focal length res / 2 (a
    90-degree field of view) unless given) on a ring of radius 1.2 at
    height 0.3, looking at the origin."""
    from nerf_emitter_tpu_torch.cameras.cameras import Cameras

    a = torch.arange(count, dtype=torch.float32) * (2.0 * math.pi / count)
    o = torch.stack([1.2 * torch.sin(a), torch.full_like(a, 0.3), 1.2 * torch.cos(a)], dim=-1)
    f = -o / o.norm(dim=-1, keepdim=True)
    r = torch.linalg.cross(f, torch.tensor([0.0, 1.0, 0.0]).expand_as(f), dim=-1)
    r = r / r.norm(dim=-1, keepdim=True)
    u = torch.linalg.cross(r, f, dim=-1)
    c2w = torch.stack([r, u, -f, o], dim=-1)
    f = torch.full((count,), res / 2.0 if focal is None else focal)
    c = torch.full((count,), res / 2.0)
    return Cameras(camera_to_worlds=c2w.to(device), fx=f.to(device), fy=f.to(device),
                   cx=c.to(device), cy=c.to(device), width=res, height=res)


def frozen_brightness_difference(model, rays, box, h: float) -> torch.Tensor:
    """Central difference of the luminance along each ray's direction with
    the samples' distances held where the model's sampler puts them for
    these rays: the function `point_lights`' jvp differentiates (the
    resample stops the gradient through the weights)."""
    from nerf_emitter_tpu_torch.ops import rendering
    from nerf_emitter_tpu_torch.ops.samplers import proposal_sample
    from nerf_emitter_tpu_torch.utils.math import luminance

    fns = [lambda p, c, net=net: net(p, disable_aabb=box, disable_aabb_on=True) for net in model.proposal_networks]
    samples, _, _ = proposal_sample(rays, fns, list(model.num_proposal_samples), model.num_nerf_samples)

    def brightness(shift):
        pos = samples.frustums.get_positions() + shift * rays.directions[:, None, :]
        dens, geo = model.field.get_density(pos, disable_aabb=box, disable_aabb_on=True)
        rgb = model.field.get_rgb(geo, rays.directions[:, None, :].expand(pos.shape), samples.camera_indices)
        return luminance(rendering.composite_rgb(rgb, samples.get_weights(dens),
                                                 background_color=model.background_color, hdr=True,
                                                 is_training=False))

    return (brightness(h) - brightness(-h)) / (2.0 * h)


def hash_grid_phase(dev, seed: int, rays: int = RAYS) -> dict:
    """K7 (csrc/hash_grid.cu) on the `hash` model at nerfacto's published
    widths (2^19 tables, max_res 2048; proposal grids 2^17, up to 64 and
    256), random weights and tables from `seed`, on `rays` rays from a
    sphere of radius 2.4 toward the scene.

    Per grid (proposal_0, proposal_1, field) at the positions one training
    forward gives it: each launcher against its plain twin on the same
    card (`hash_encode`: its forward, autograd's backward and forward mode
    through it; the forward bit for bit; the table's gradient against the
    twin in float64, the positions' gradient and the tangent against the twin
    in float32, by relative L2: atomics reorder the sums), each timed
    beside its bound (bytes: positions in, features or gradients through,
    the table read or its gradient written once) and its twin. Then the
    model's training forward and backward through the kernels against the
    plain twin (`hash_encode` under autograd): the answer, every
    parameter's gradient, both timed; and `point_lights` (its jvp through
    the forward's tangent mode) against the plain twin. Only K7's
    launchers run: counted by name."""
    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.cameras.rays import RayBundle
    from nerf_emitter_tpu_torch.fields import encodings, nerfacto_field
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
    from nerf_emitter_tpu_torch.ops import hash_grid as hg

    torch.manual_seed(seed)
    model = NerfactoModel(AABB, num_nerf_samples=NERF_SAMPLES, num_proposal_samples=SAMPLES, num_cameras=128,
                          appearance_embedding_dim=32, implementation="hash", log2_hashmap_size=19, max_res=2048,
                          device=dev)
    with torch.no_grad():
        for net in (*model.proposal_networks, model.field):
            net.hash_table.uniform_(-1e-2, 1e-2)  # larger than init, so the field varies across the box
    g = torch.Generator(device="cpu").manual_seed(seed + 7)
    o = torch.randn((rays, 3), generator=g)
    o = 2.4 * o / o.norm(dim=-1, keepdim=True)
    d = -o / 2.4 + 0.3 * torch.randn((rays, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    bundle = RayBundle(origins=o.to(dev), directions=d.to(dev), pixel_area=torch.full((rays, 1), 1e-4, device=dev),
                       nears=torch.full((rays, 1), 0.05, device=dev), fars=torch.full((rays, 1), 6.0, device=dev),
                       camera_indices=torch.randint(0, 128, (rays, 1), generator=g).to(dev))
    gen_seed = seed + 11
    nets = {"proposal_0": model.proposal_0, "proposal_1": model.proposal_1, "field": model.field}
    real = nerfacto_field.hash_grid
    seen = []

    def recording(table, positions, spec):
        seen.append(positions.detach())
        return real(table, positions, spec)

    def plain(table, positions, spec):
        return encodings.hash_encode(table, positions, spec)

    def train_forward():
        return model(bundle, train=True, generator=torch.Generator(device=dev).manual_seed(gen_seed))

    def table_twin(table, pos, gout, spec):
        return hg._plain_grads(table, pos, gout, spec, need_positions=False)[0]

    def positions_twin(table, pos, gout, spec):
        return hg._plain_grads(table, pos, gout, spec, need_table=False)[1]

    nerfacto_field.hash_grid = recording
    try:
        with torch.no_grad():
            train_forward()
    finally:
        nerfacto_field.hash_grid = real
    report = kernels.build()["ptxas"].get("hash_grid", "")
    ptxas = {k: ptxas_of(report, k) for k in ("forward_kernel", "table_grad_kernel", "positions_grad_kernel")}
    grids, checks = {}, {}
    for (name, net), pos in zip(nets.items(), seen):
        spec, table = net.grid_spec, net.hash_table.detach()
        n, lf, tb = pos.shape[0], spec.out_dim, table.numel() * 4
        gout = torch.randn((n, lf), generator=torch.Generator(device=dev).manual_seed(seed + 13), device=dev)
        tan = torch.randn((n, 3), generator=torch.Generator(device=dev).manual_seed(seed + 17), device=dev)
        with torch.no_grad():
            fk = hg._kernel_forward(table, pos, spec)[0]
            ft = encodings.hash_encode(table, pos, spec)
            c = {"forward_bit_equal": bool(torch.equal(fk, ft)),
                 "forward": close(fk, ft, rtol=1e-6, atol=1e-9)}
            del fk, ft
            c["table_grad"] = vectors_close(hg._kernel_table_grad(table, pos, gout, spec),
                                            table_twin(table.double(), pos, gout.double(), spec),
                                            rel_l2=1e-5, cos=0.99999)
            c["positions_grad"] = vectors_close(hg._kernel_positions_grad(table, pos, gout, spec),
                                                positions_twin(table, pos, gout, spec),
                                                rel_l2=1e-4, cos=0.9999)
            c["tangent"] = vectors_close(hg._kernel_forward(table, pos, spec, tangent=tan, primal=False)[1],
                                         hg._plain_tangent(table, pos, tan, spec), rel_l2=1e-4, cos=0.9999)
            ms = {"forward": cuda_ms(lambda: hg._kernel_forward(table, pos, spec), 5),
                  "table_grad": cuda_ms(lambda: hg._kernel_table_grad(table, pos, gout, spec), 5),
                  "positions_grad": cuda_ms(lambda: hg._kernel_positions_grad(table, pos, gout, spec), 5),
                  "tangent": cuda_ms(lambda: hg._kernel_forward(table, pos, spec, tangent=tan, primal=False), 5)}
            plain_ms = {"forward": cuda_ms(lambda: encodings.hash_encode(table, pos, spec), 1),
                        "table_grad": cuda_ms(lambda: table_twin(table, pos, gout, spec), 1),
                        "positions_grad": cuda_ms(lambda: positions_twin(table, pos, gout, spec), 1),
                        "tangent": cuda_ms(lambda: hg._plain_tangent(table, pos, tan, spec), 1)}
        nbytes = {"forward": n * 4 * (3 + lf) + tb, "table_grad": n * 4 * (3 + lf) + tb,
                  "positions_grad": n * 4 * (3 + lf + 3) + tb, "tangent": n * 4 * (3 + 3 + lf) + tb}
        bound = {k: bound_ms(0.0, b)[0] for k, b in nbytes.items()}
        grids[name] = dict(points=n, levels=spec.num_levels, rows=spec.total_size, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by="bytes",
                           roofline_pct={k: 100.0 * bound[k] / ms[k] for k in bound})
        checks[name] = c
        del gout, tan
    del seen
    torch.cuda.empty_cache()

    # the model's training forward and backward: kernels against the twin
    def forward_backward():
        model.zero_grad(set_to_none=True)
        out = train_forward()
        w = torch.Generator(device=dev).manual_seed(seed + 19)
        loss = (out["rgb"] * torch.rand(out["rgb"].shape, generator=w, device=dev)).sum()
        for wl in out["weights_list"]:
            loss = loss + (wl * torch.rand(wl.shape, generator=w, device=dev)).sum()
        loss.backward()
        return out["rgb"].detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()
                                     if p.grad is not None}

    kernels.reset_launches()
    rgb_k, grads_k = forward_backward()
    torch.cuda.synchronize()
    model_launches = dict(kernels.launches)
    step_ms = cuda_ms(forward_backward, 3)
    nerfacto_field.hash_grid = plain
    try:
        rgb_p, grads_p = forward_backward()
        plain_step_ms = cuda_ms(forward_backward, 1)
    finally:
        nerfacto_field.hash_grid = real
    model_checks = {"rgb": close(rgb_k, rgb_p, rtol=1e-5, atol=1e-7)}
    model_checks |= {f"grad.{k}": vectors_close(grads_k[k], grads_p[k], rel_l2=1e-4, cos=0.9999) for k in grads_p}
    del rgb_k, grads_k, rgb_p, grads_p
    torch.cuda.empty_cache()

    # point lights: the jvp through the forward's tangent mode
    m = 4096
    sub = bundle.replace(**{k: getattr(bundle, k)[:m] for k in ("origins", "directions", "pixel_area", "nears",
                                                                  "fars", "camera_indices")})
    kernels.reset_launches()
    pl_k = model.point_lights(sub)
    torch.cuda.synchronize()
    pl_launches = dict(kernels.launches)
    nerfacto_field.hash_grid = plain
    try:
        pl_p = model.point_lights(sub)
    finally:
        nerfacto_field.hash_grid = real
    pl_checks = {k: close(pl_k[k], pl_p[k], rtol=1e-4, atol=1e-6) for k in ("rgb", "luminance", "depth")}
    pl_checks["brightness_grad"] = vectors_close(pl_k["brightness_grad"], pl_p["brightness_grad"],
                                                 rel_l2=1e-3, cos=0.999)
    rec = dict(phase="hash_grid", rays=rays, grids=grids, ptxas=ptxas, checks=checks,
               model_step_ms=step_ms, model_plain_step_ms=plain_step_ms, model_launches=model_launches,
               model_checks=model_checks, point_lights_launches=pl_launches, point_lights_checks=pl_checks,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, bundle, pl_k, pl_p
    torch.cuda.empty_cache()
    held = [c for grid in checks.values() for k, c in grid.items() if k != "forward_bit_equal"]
    held += [*model_checks.values(), *pl_checks.values()]
    ours = {k for k in {**model_launches, **pl_launches} if not k.startswith("hash_grid")}
    if not all(c["within"] for c in held) or ours or "hash_grid_forward[jvp]" not in pl_launches:
        emit(rec)
        raise AssertionError(f"K7 disagrees with its twin or another kernel ran: {ours}")
    return rec


def pretrain(dev, seed: int, views: int = TRAIN_VIEWS, res: int = TRAIN_RES, rays: int = TRAIN_RAYS,
             steps: int = TRAIN_STEPS, implementation: str = "freq"):
    """NeRF pretraining as sdf-nerfacto runs it (configs/methods.py:114-129):
    the `freq` model with ModelSettings' defaults and one appearance vector
    per train view, or with `implementation="hash"` nerfacto's hash grids at
    their published widths (2^19 rows, max_res 2048; the benchmark's
    `sdf-nerfacto-hashgrid` configuration); 2^14 rays a batch, near 0.05, far 1e3; rawnerf plus
    relative_l1, interlevel 1.0, distortion 0.002; lr 1e-3 for the fields
    and the proposals decaying to 1e-4 over 2,320 steps with the x0.01 drop
    at step 2,000; the proposal anneal over 1,000 steps, slope 10. On the
    synthetic scene (data/synthetic.py: views at res^2) parsed by the
    instant-ngp parser (scene_scale 1/3, aabb_scale 1.5, a 0.9 train
    fraction), `steps` steps from `seed`. A held-out view rendered (chunks
    of 4,096 rays) before and after. The `freq` step launches none of the
    port's kernels; the `hash` step K7's forward and table gradient once a
    grid (3 each a step), counted over the steps alone. Returns (model, the
    phase's record, the checks); the caller raises on a failed check."""
    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.data.datamanager import build_dataset
    from nerf_emitter_tpu_torch.data.dataparsers.instant_ngp import InstantNGPDataparserConfig, parse_instant_ngp
    from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset
    from nerf_emitter_tpu_torch.engine.train_loop import (TrainConfig, create_train_state, eval_image_metrics,
                                                          make_render_fn, make_train_step)
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
    from nerf_emitter_tpu_torch.scripts.profiling import device_trace

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_dataset(Path(tmp), n_views=views, width=res, height=res, seed=seed)
        dp = InstantNGPDataparserConfig(data=Path(tmp), scene_scale=1.0 / 3.0, aabb_scale=1.5, eval_mode="fraction")
        ds = build_dataset(parse_instant_ngp(dp, "train"), device=dev)
        eval_ds = build_dataset(parse_instant_ngp(dp, "val"), device=dev)
    data_s = time.perf_counter() - t0
    s = dp.aabb_scale
    torch.manual_seed(seed + 6)
    widths = dict(log2_hashmap_size=19, max_res=2048) if implementation == "hash" else {}
    model = NerfactoModel(((-s,) * 3, (s,) * 3), num_cameras=len(ds.cameras), implementation=implementation,
                          device=dev, **widths)
    config = TrainConfig(num_rays_per_batch=rays, near=0.05, far=1e3, rgb_loss="rawnerf",
                         rgb_loss_second="relative_l1", interlevel_mult=1.0, distortion_mult=0.002,
                         anneal_steps=1000, anneal_slope=10.0, max_steps=2320, lr_fields=1e-3, lr_proposal=1e-3,
                         step_pretrain=2000)
    state, optimizer = create_train_state(model, config)
    step = make_train_step(model, config, optimizer)
    render = make_render_fn(model, config, chunk=4096)
    gen = torch.Generator(device=dev).manual_seed(seed + 6)

    def evaluate():
        img = render(eval_ds.cameras, 0, eval_ds.images.shape[1], eval_ds.images.shape[2])["rgb"]
        return eval_image_metrics(img, eval_ds.images[0], is_hdr=eval_ds.is_hdr)

    eval_start = evaluate()
    kernels.reset_launches()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    marks, hist = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        hist.append(step(state, ds, gen))
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = dict(kernels.launches)
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    ms = sum(step_ms[10:]) / len(step_ms[10:]) if len(step_ms) > 10 else None
    table = {k: torch.stack([m[k] for m in hist]).float().cpu() for k in hist[0]}
    window = min(10, steps // 2)
    first = {k: float(v[:window].mean()) for k, v in table.items()}
    last = {k: float(v[-window:].mean()) for k, v in table.items()}
    # where a step's time goes: the device timeline of 3 steps (after the
    # warm-up step device_trace takes), which train on
    step_trace = device_trace(lambda: step(state, ds, gen), calls=3, top=8) if cuda else None
    eval_end = evaluate()
    rec = dict(phase="train" if implementation == "freq" else f"train_{implementation}",
               views=[len(ds.cameras), len(eval_ds.cameras)], res=res, rays_per_batch=rays,
               steps=steps, steps_before_end_eval=state.step, data_s=data_s, train_s=train_s, ms_per_step=ms,
               ms_per_step_over="steps 11-%d, CUDA events" % steps, rays_per_s=rays / (ms * 1e-3) if ms else None,
               step_ms_first3=step_ms[:3], peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
               first10=first, last10=last, launches_during_training=train_launches,
               eval_start=eval_start, eval_end=eval_end, lrs_end=optimizer.lrs(), trace_3_steps=step_trace)
    finite = all(bool(torch.isfinite(v).all()) for v in table.values())
    metrics_finite = all(math.isfinite(v) for m in (eval_start, eval_end) for v in m.values())
    checks = {"losses_finite": finite,
              "rgb_loss_fell_0.7x": last["rgb_loss"] < 0.7 * first["rgb_loss"],
              "eval_metrics_finite": metrics_finite,
              "eval_psnr_rose": eval_end["psnr"] > eval_start["psnr"],
              **({"no_port_kernel_in_training": not train_launches} if implementation == "freq" else
                 {"k7_alone_in_training": train_launches == {"hash_grid_forward": 3 * steps,
                                                             "hash_grid_backward": 3 * steps}})}
    return model, rec, checks



def takeover_render_config():
    """The takeover's render settings as sdf-nerfacto ships them
    (pipelines/nerf_emitter.py:241-281): one-sample MIS, the soft
    silhouette, no secondary warp; the default march."""
    from nerf_emitter_tpu_torch.renderer.integrator import RenderConfig

    return RenderConfig(mis_mode="one_sample", reparam="soft", warp_secondary=False)


def render_check(dev, model, vmf, seed: int, res: int = RENDER_RES, spp: int = RENDER_SPP, grid: int = 64):
    """One view (camera 0 of an 8-camera ring, a 53-degree field of view)
    of composite_sdf_grid(grid)
    with albedo 0.7 at res^2, spp samples in one slice: under an envmap on
    `dev` and on the CPU from the same draws (rgb, hit, alpha, depth; at
    most 0.5% of the rays' hits may differ, the rest held: depth within
    2e-3, the rest within rtol 1e-2 / atol 1e-3), with the march's CUDA
    graph against the eager march on the card (bit for bit); then lit by
    the emitter through K5 and through the model's plain forward at far =
    4, proposed by the vMF mixture (rtol 3e-2, atol 1e-3). Returns (record,
    checks, K5-lit launches)."""
    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn
    from nerf_emitter_tpu_torch.renderer import sphere_trace as st
    from nerf_emitter_tpu_torch.renderer.emitters import EnvmapEmitter
    from nerf_emitter_tpu_torch.renderer.grid3d import composite_sdf_grid
    from nerf_emitter_tpu_torch.renderer.integrator import draw_direct, render_spp
    from nerf_emitter_tpu_torch.renderer.scene import SdfScene
    from nerf_emitter_tpu_torch.renderer.sensors import camera_rays_in_render_space

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(seed + 8)
    h, w = 16, 32
    rows = torch.linspace(0.3, 1.7, h)[:, None, None]
    env_img = (0.5 + torch.rand((h, w, 3), generator=g)) * rows
    cams = ring_cameras(8, res, cpu, focal=res)
    o, d = camera_rays_in_render_space(cams, 0, res, res, 1.0, g)
    tex = torch.full((32, 32, 32, 3), 0.7)

    def scene_on(device, **kw):
        return SdfScene(sdf=composite_sdf_grid(grid).to(device), albedo=tex.to(device),
                        roughness=torch.full((32, 32, 32, 1), 0.5, device=device), **kw)

    rc = takeover_render_config()
    cpu_scene = scene_on(cpu, envmap=EnvmapEmitter.create(env_img))
    draws = draw_direct(cpu_scene, o.shape[0], g, lead=(spp,))
    with torch.no_grad():
        ref = render_spp(cpu_scene, o, d, spp, draws=draws, config=rc, spp_per_batch=spp)
        got = render_spp(scene_on(dev, envmap=EnvmapEmitter.create(env_img.to(dev))), o.to(dev), d.to(dev), spp,
                         draws=draws.map(lambda t: t.to(dev)), config=rc, spp_per_batch=spp)
    same = got["hit"].cpu() == ref["hit"]
    checks = {"hit_disagreement_share": dict(share=float((~same).float().mean()), bar=0.005,
                                             within=float((~same).float().mean()) <= 0.005)}
    for k, (rtol, atol) in (("rgb", (1e-2, 1e-3)), ("alpha", (1e-2, 1e-3)), ("depth", (0.0, 2e-3))):
        a, b = got[k].cpu()[same], ref[k][same]
        checks[k] = close(a, b, rtol=rtol, atol=atol)
    if dev.type == "cuda":
        sdf = cpu_scene.sdf.to(dev)
        graphed = st._march(sdf, o.to(dev), d.to(dev), rc.trace)
        eager = st._march_eager(sdf, o.to(dev), d.to(dev), rc.trace)
        checks["march_graph_vs_eager"] = dict(bitwise=all(torch.equal(a, b) for a, b in zip(graphed, eager)),
                                              max_abs_err=0.0)
        checks["march_graph_vs_eager"]["within"] = checks["march_graph_vs_eager"]["bitwise"]
    # the emitter: K5 against the model forward, the vMF mixture proposing
    lit = scene_on(dev, guiding=vmf)
    lit_draws = draw_direct(lit, o.shape[0], torch.Generator(device=dev).manual_seed(seed + 9), lead=(spp,))
    outs, launches = {}, {}
    for tag, fused in (("k5", True), ("model_forward", False)):
        fn = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, use_fused=fused)(camera_index=0)
        kernels.reset_launches()
        with torch.no_grad():
            outs[tag] = render_spp(lit, o.to(dev), d.to(dev), spp, draws=lit_draws, emitter_fn=fn, config=rc,
                                   spp_per_batch=spp)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches[tag] = dict(kernels.launches)
    checks["k5_vs_model_forward_far4"] = close(outs["k5"]["rgb"], outs["model_forward"]["rgb"], rtol=3e-2, atol=1e-3)
    rec = dict(res=res, spp=spp, grid=grid, rays=o.shape[0], hits=int(ref["hit"].sum()),
               launches=launches, rgb_mean=float(got["rgb"].mean()), lit_rgb_mean=float(outs["k5"]["rgb"].mean()))
    return rec, checks, launches["k5"]


class GradProbe:
    """An optimiser whose state also keeps the last gradients it was given."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, scene):
        return (self.tx.init(scene), None)

    def update(self, grads, state):
        updates, inner = self.tx.update(grads, state[0])
        return updates, (inner, grads)


def takeover(dev, seed: int, model, student, vmf, *, gt_res: int = 256, sizes=(64, 128, 256), steps=(4, 4, 1),
             cameras: int = 8, batch: int = 4, spp: int = 32, spp_attached: int = 16, spp_per_batch: int = 8,
             gt_spp: int = 8, trace: bool = True):
    """The takeover as sdf-nerfacto runs it: the recipe
    diffuse-12-relativel1-hqq (configs/methods.py:63: 64^3 SDF from a
    sphere of radius 0.25, 32^3 textures, redistancing every 5 steps,
    Sobolev lambda 2 with uniform Adam, upsamples at steps 64 and 128 with
    the lr x0.25), the pipeline's defaults (pipelines/nerf_emitter.py:
    241-281,734-750: batch 4, spp 32, spp_attached 16, spp_per_batch 8, the
    render settings of takeover_render_config), lit by the distilled
    student with the vMF mixture proposing. The GT: composite_sdf_grid(64)
    with albedo 0.7 rendered under the same student on a ring of `cameras`
    cameras (a 53-degree field of view) at gt_res^2 (gt_spp samples),
    resized by the step to the render size. Steps: (a) steps[0] from step 0 at sizes[0]^2, (b) steps[1]
    numbered 63.. at sizes[1]^2 (post_step_host upsamples to 127^3 at step
    64 and redistances at 65), (c) steps[2] at sizes[2]^2 on the 253^3 grid
    (4 gradient bands under the budget rule at 256^2). Then one step at
    sizes[0]^2 lit by K5 (far = 4), its gradient held against the same
    step's lit by the model's plain forward: the sdf gradient at the
    backward phase's bars (relative L2 0.35, cosine 0.9: it carries the
    emitter's gradient with respect to the shading points, which the two
    samplers place differently), the albedo gradient (the emitter's values
    alone) at 0.1 and 0.99. Returns (record, checks, K5 step's launches)."""
    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn
    from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import (SdfOptState, TakeoverConfig, build_sdf_optimizer,
                                                                init_mean_params, make_sdf_train_step, post_step_host)
    from nerf_emitter_tpu_torch.renderer.grid3d import composite_sdf_grid
    from nerf_emitter_tpu_torch.renderer.integrator import render_spp
    from nerf_emitter_tpu_torch.renderer.optimize import get_opt_config
    from nerf_emitter_tpu_torch.renderer.scene import SdfScene
    from nerf_emitter_tpu_torch.renderer.sensors import camera_rays_in_render_space
    from nerf_emitter_tpu_torch.renderer.sphere_trace import clear_march_graphs
    from nerf_emitter_tpu_torch.scripts.profiling import device_trace
    from nerf_emitter_tpu_torch.serving.distill import make_student_emitter_fn_of

    cuda = dev.type == "cuda"
    cfg = get_opt_config(TAKEOVER_RECIPE)
    rc = takeover_render_config()
    cams = ring_cameras(cameras, gt_res, dev, focal=gt_res)
    student_of = make_student_emitter_fn_of(student, scene_scale=1.0, object_aabb=OBJECT_BOX)

    def student_for_camera(c, r):
        return student_of(model, camera_index=c, rot_id=r)

    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    t0 = time.perf_counter()
    gt_scene = SdfScene(sdf=composite_sdf_grid(cfg.init_res, device=dev),
                        albedo=torch.full((cfg.tex_res,) * 3 + (3,), 0.7, device=dev),
                        roughness=torch.full((cfg.tex_res,) * 3 + (1,), 0.5, device=dev), guiding=vmf)
    gts, masks = [], []
    with torch.no_grad():
        for i in range(cameras):
            o, d = camera_rays_in_render_space(cams, i, gt_res, gt_res, 1.0, gen)
            out = render_spp(gt_scene, o, d, gt_spp, gen, emitter_fn=student_for_camera(i, None), config=rc,
                             spp_per_batch=gt_spp)
            gts.append(out["rgb"].reshape(gt_res, gt_res, 3))
            masks.append(out["hit"].reshape(gt_res, gt_res, 1).float())
    gts, masks = torch.stack(gts), torch.stack(masks)
    if cuda:
        torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0

    lr_scale = {}

    def make_step(size, tx, **kw):
        tk = TakeoverConfig(spp=spp, spp_per_batch=spp_per_batch, image_height=size, image_width=size,
                            scene_scale=1.0, spp_attached=spp_attached)
        return make_sdf_train_step(cfg, tk, tx, render_config=rc, **kw)

    scene0 = SdfScene.create(sdf_res=cfg.init_res, tex_res=cfg.tex_res, bsdf_type=cfg.bsdf_type, init_radius=0.25,
                             device=dev).replace(guiding=vmf)
    tx = build_sdf_optimizer(cfg)
    state = SdfOptState(step=0, scene=scene0, opt_state=tx.init(scene0), mean_params=init_mean_params(scene0))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    metrics, stages = [], {}

    def run(tag, size, n):
        nonlocal state, tx
        step_fn = make_step(size, tx, emitter_for_camera=student_for_camera)
        ms, first = [], None
        for _ in range(n):
            cam = torch.randperm(cameras, generator=gen, device=dev)[:batch]
            if cuda:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step_fn(state, cams, cam, gts[cam], masks[cam], gen)
            shape = state.scene.sdf.shape
            state = post_step_host(state, cfg, tx)
            if state.scene.sdf.shape != shape:
                # the pipeline's volume-upsample lr decay: a new optimiser
                # and a step built around it
                for v in cfg.variables:
                    if v.lr_decay_at_up != 1.0:
                        lr_scale[v.name] = lr_scale.get(v.name, 1.0) * v.lr_decay_at_up
                tx = build_sdf_optimizer(cfg, lr_scale)
                state = state.replace(opt_state=tx.init(state.scene))
                step_fn = make_step(size, tx, emitter_for_camera=student_for_camera)
            if cuda:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()} | dict(step=state.step - 1, size=size,
                                                                        grid=int(state.scene.sdf.shape[0])))
        stages[tag] = dict(size=size, steps=[metrics[-n]["step"], metrics[-1]["step"]],
                           grid_after=int(state.scene.sdf.shape[0]), ms_per_step=ms,
                           ms_per_step_after_first=sum(ms[1:]) / max(1, len(ms) - 1) if len(ms) > 1 else None,
                           bands=step_fn.n_grad_bands, detached_chunks=step_fn.chunks)
        return step_fn

    step_a = run("a", sizes[0], steps[0])
    step_trace = None
    if trace:
        cam = torch.arange(batch, device=dev)
        step_trace = device_trace(lambda: step_a(state, cams, cam, gts[cam], masks[cam], gen), calls=1, top=8)
    state = state.replace(step=63)
    run("b", sizes[1], steps[1])
    state = post_step_host(state.replace(step=128), cfg, tx)
    for v in cfg.variables:
        if v.lr_decay_at_up != 1.0:
            lr_scale[v.name] = lr_scale.get(v.name, 1.0) * v.lr_decay_at_up
    tx = build_sdf_optimizer(cfg, lr_scale)
    state = state.replace(opt_state=tx.init(state.scene))
    run("c", sizes[2], steps[2])
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
    del state
    clear_march_graphs()

    # the K5-lit step against the same step lit by the model's forward, on
    # the same draws, from the sphere init
    probe_grads, k5_launches, k5_ms, comparison_peak = {}, None, None, {}
    draws = None
    for tag, fused in (("k5", True), ("model_forward", False)):
        fn_of = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, detach_nerf=True, use_fused=fused)
        probe = GradProbe(build_sdf_optimizer(cfg))
        step_fn = make_step(sizes[0], probe, emitter_for_camera=lambda c, r, f=fn_of: f(camera_index=c, rot_id=r))
        s0 = SdfOptState(step=0, scene=scene0, opt_state=probe.init(scene0))
        cam = torch.arange(batch, device=dev)
        if draws is None:
            draws = step_fn.draw(scene0, batch, gen)
        kernels.reset_launches()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        new, m = step_fn(s0, cams, cam, gts[cam], masks[cam], draws=draws)
        if cuda:
            torch.cuda.synchronize()
            comparison_peak[tag] = torch.cuda.max_memory_allocated() / 2**30
        if tag == "k5":
            k5_ms, k5_launches = (time.perf_counter() - t1) * 1e3, dict(kernels.launches)
            k5_metrics = {k: float(v) for k, v in m.items()}
        probe_grads[tag] = new.opt_state[1]
        del new
        clear_march_graphs()
    grad_checks = {f"{k}_grad_k5_vs_model_forward_far4": vectors_close(probe_grads["k5"][k],
                                                                          probe_grads["model_forward"][k],
                                                                          rel_l2=bar[0], cos=bar[1])
                   for k, bar in (("sdf", (0.35, 0.9)), ("albedo", (0.1, 0.99)))}
    finite = all(math.isfinite(v) for m in metrics + [k5_metrics] for v in m.values())
    checks = dict(grad_checks, losses_and_gnorms_finite=finite)
    rec = dict(recipe=TAKEOVER_RECIPE, cameras=cameras, gt_res=gt_res, gt_spp=gt_spp, gt_s=gt_s, batch=batch,
               spp=spp, spp_attached=spp_attached, spp_per_batch=spp_per_batch, stages=stages,
               peak_mem_gb=peak, peak_mem_gb_k5_and_forward_lit_steps=comparison_peak, metrics=metrics,
               trace_one_step_a=step_trace,
               k5_step=dict(size=sizes[0], ms=k5_ms, launches=k5_launches, metrics=k5_metrics),
               cut=f"steps {steps} of 320 at sizes {list(sizes)}: (a) from step 0, (b) from step 63, (c) at step 128")
    return rec, checks, k5_launches


def recovery(dev, seed: int, steps: int = 40):
    """The JAX suite's shape recovery (tests/test_sdf_optimization.py:95-152)
    on `dev`: a box (half extent 0.22) from a sphere (radius 0.25), 33^3,
    4 cameras of 32^2, spp 4, soft reparam, envmap 1.5, 40 steps of the
    exact-mode step with validate_params after each. Bars: the mean view
    loss of the last 5 steps below 0.7x the first, the last mask loss
    below 0.3x the first."""
    from nerf_emitter_tpu_torch.cameras.cameras import Cameras
    from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import (SdfOptState, TakeoverConfig, build_sdf_optimizer,
                                                                make_sdf_train_step)
    from nerf_emitter_tpu_torch.renderer.emitters import EnvmapEmitter
    from nerf_emitter_tpu_torch.renderer.grid3d import box_sdf_grid
    from nerf_emitter_tpu_torch.renderer.integrator import RenderConfig, render_spp
    from nerf_emitter_tpu_torch.renderer.optimize import SdfOptConfig, VariableSpec, validate_params
    from nerf_emitter_tpu_torch.renderer.scene import SdfScene
    from nerf_emitter_tpu_torch.renderer.sensors import camera_rays_in_render_space
    from nerf_emitter_tpu_torch.renderer.sphere_trace import SphereTraceConfig, clear_march_graphs

    n, res = 4, 32
    c2ws = []
    for i in range(n):
        th = 2 * math.pi * i / n
        eye = 1.6 * torch.tensor([math.cos(th), 0.35, math.sin(th)])
        fwd = -eye / eye.norm()
        right = torch.linalg.cross(fwd, torch.tensor([0.0, 1.0, 0.0]))
        right = right / right.norm()
        c2ws.append(torch.stack([right, torch.linalg.cross(right, fwd), -fwd, eye], dim=1))
    f = torch.full((n,), 40.0, device=dev)
    cams = Cameras(camera_to_worlds=torch.stack(c2ws).to(dev), fx=f, fy=f, cx=torch.full((n,), res / 2, device=dev),
                   cy=torch.full((n,), res / 2, device=dev), width=res, height=res)
    rc = RenderConfig(trace=SphereTraceConfig(max_steps=48, t_max=3.0), reparam="soft")
    env = EnvmapEmitter.create(torch.ones((8, 16, 3), device=dev) * 1.5)
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    gt_scene = SdfScene.create(sdf_res=33, tex_res=4, envmap=env, init_albedo=0.7, device=dev).replace(
        sdf=box_sdf_grid(33, half_extent=0.22, device=dev))
    gts, masks = [], []
    with torch.no_grad():
        for i in range(n):
            o, d = camera_rays_in_render_space(cams, i, res, res, 1.0)
            out = render_spp(gt_scene, o, d, 8, gen, config=rc)
            gts.append(out["rgb"].reshape(res, res, 3))
            masks.append(out["hit"].reshape(res, res, 1).float())
    gts, masks = torch.stack(gts), torch.stack(masks)
    cfg = SdfOptConfig(name="test", bsdf_type=0, loss="relative_l1",
                       variables=(VariableSpec("sdf", lr=3e-3, redistance_freq=10),
                                  VariableSpec("albedo", lr=1e-2, clamp=(0.0, 1.0)),
                                  VariableSpec("roughness", lr=0.0, clamp=(0.02, 1.0))),
                       render_upsample_iter=(), curvature_mult=0.002, curvature_epsilon=0.04)
    tk = TakeoverConfig(spp=4, image_height=res, image_width=res, scene_scale=1.0, laplacian_mult=1e-3)
    scene0 = SdfScene.create(sdf_res=33, tex_res=4, envmap=env, init_albedo=0.5, init_radius=0.25, device=dev)
    tx = build_sdf_optimizer(cfg)
    state = SdfOptState(step=0, scene=scene0, opt_state=tx.init(scene0))
    step_fn = make_sdf_train_step(cfg, tk, tx, render_config=rc)
    cam = torch.arange(n, device=dev)
    view, mask = [], []
    t0 = time.perf_counter()
    for it in range(steps):
        state, m = step_fn(state, cams, cam, gts, masks, gen)
        state = state.replace(scene=validate_params(state.scene, cfg, it))
        view.append(float(m["view_loss"]))
        mask.append(float(m["mask_loss"]))
    seconds = time.perf_counter() - t0
    clear_march_graphs()
    last5 = sum(view[-5:]) / 5
    checks = {"view_last5_below_0.7x_first": last5 < 0.7 * view[0],
              "mask_last_below_0.3x_first": mask[-1] < 0.3 * mask[0],
              "losses_finite": all(math.isfinite(v) for v in view + mask)}
    rec = dict(steps=steps, seconds=seconds, ms_per_step=seconds * 1e3 / steps, view_first=view[0],
               view_last5_mean=last5, view_ratio=last5 / view[0], mask_first=mask[0], mask_last=mask[-1],
               mask_ratio=mask[-1] / mask[0], view=view, mask=mask)
    return rec, checks


def tsdf_fragile(cams, depth, res: int, scene_scale: float, object_aabb, px=1e-3, dist=1e-5):
    """Voxels that two f32 fusions may fuse differently beyond rounding,
    found in float64 (tests/test_torch_pipeline.py's `_fragile`): in some
    view that sees the voxel, the projection within `px` pixels of an image
    edge, the observed distance within `dist` of -truncation, or bilinear
    depth taps that straddle the silhouette (a 1e3 miss beside a surface);
    or the centre within `dist` of the object box's faces."""
    f64, dev = torch.float64, depth.device
    c2w = cams.camera_to_worlds.to(f64)
    h, w = depth.shape[1:3]
    trunc = 4.0 / res
    xs = torch.linspace(0.0, 1.0, res, dtype=f64, device=dev)
    vox = (torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3) * 2.0 - 1.0) * scene_scale
    near = torch.zeros(vox.shape[0], dtype=torch.bool, device=dev)
    for b in range(c2w.shape[0]):
        p = (vox - c2w[b, :, 3]) @ c2w[b, :, :3]
        z = -p[:, 2]
        zc = z.clamp(min=1e-6)
        u = float(cams.fx[b]) * p[:, 0] / zc + float(cams.cx[b])
        v = -float(cams.fy[b]) * p[:, 1] / zc + float(cams.cy[b])
        ui, vi = u.clamp(0, w - 1), v.clamp(0, h - 1)
        u0, v0 = ui.floor().long(), vi.floor().long()
        u1, v1 = (u0 + 1).clamp(max=w - 1), (v0 + 1).clamp(max=h - 1)
        fu, fv = ui - u0, vi - v0
        dm = depth[b, ..., 0].to(f64)
        taps = torch.stack([dm[v0, u0], dm[v0, u1], dm[v1, u0], dm[v1, u1]])
        dd = taps[0] * (1 - fu) * (1 - fv) + taps[1] * fu * (1 - fv) + taps[2] * (1 - fu) * fv + taps[3] * fu * fv
        sdf_obs = dd * zc / torch.linalg.vector_norm(p, dim=-1).clamp(min=1e-6) - z
        edge = torch.stack([u.abs(), (u - (w - 1)).abs(), v.abs(), (v - (h - 1)).abs()]).amin(0) < px
        straddle = (taps.amax(0) >= 1e3) & (taps.amin(0) < 1e3) & (sdf_obs > -trunc)
        near |= (z > 0) & (edge | straddle | ((sdf_obs + trunc).abs() < dist))
    box = torch.as_tensor(object_aabb, dtype=f64, device=dev)
    near |= (torch.minimum((vox - box[0]).abs(), (vox - box[1]).abs()) < dist).any(-1)
    return near.reshape(res, res, res, 1)


def pipeline(dev, seed: int, *, views: int = TRAIN_VIEWS, res: int = TRAIN_RES, takeover: int = 100,
             steps: int = 112, resume_to: int = 116, distill: int = 500, eval_every: int = 105,
             save_every: int = 106, extra=()):
    """sdf-nerfacto through its train CLI, in-process
    (nerf_emitter_tpu_torch.scripts.train.main), at full width and at the
    method's defaults, on the synthetic scene of the `train` phase (views at
    res^2, the instant-ngp parser), cut: the takeover at step `takeover` of
    2,000 and `steps` steps in all (12 takeover steps reach the guiding
    rebuild at takeover step 10), the cache distilled for `distill` of
    2,000 steps, an eval view at step `eval_every` and checkpoints at
    `save_every` and at the end. Then `--resume` to `resume_to` in a new
    Trainer from that checkpoint (re-distilling the cache). On the CPU
    (`dev` cpu) the CLI gets --device cpu and `extra` flags. The stages are
    timed by scripts/method_run.py's watch; the fusion's inputs and the
    state after the restore are kept for the checks. Returns (record,
    checks, the port's kernel launches over the whole path)."""
    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset
    from nerf_emitter_tpu_torch.engine import checkpoints
    from nerf_emitter_tpu_torch.engine.trainer import Trainer
    from nerf_emitter_tpu_torch.pipelines import tsdf
    from nerf_emitter_tpu_torch.scripts import method_run, train
    from nerf_emitter_tpu_torch.scripts.profiling import Stages, device_trace

    cuda = dev.type == "cuda"
    tree = checkpoints.to_tree

    def state_of(trainer):
        p = trainer.pipeline
        return (tree(trainer._nerf_tree()), tree(p.sdf_state),
                (p._takeover_size, p._takeover_spp, dict(p._lr_up_scale)))

    with tempfile.TemporaryDirectory() as tmp:
        scene = make_synthetic_dataset(Path(tmp) / "scene", n_views=views, width=res, height=res, seed=seed)
        argv = ["sdf-nerfacto", "--datacfg.data", str(scene), "--output-dir", str(Path(tmp) / "out"),
                "--experiment-name", "smoke", "--seed", str(seed), "--pipeline.takeover-step", str(takeover),
                "--pipeline.distill-steps", str(distill), "--steps-per-eval-image", str(eval_every),
                "--steps-per-save", str(save_every), *(() if cuda else ("--device", "cpu")), *extra]
        kernels.reset_launches()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Stages(dev) as st:
            method_run.watch(st)
            st.wrap(tsdf, "integrate_tsdf", keep_out=True, keep_args=True)
            st.wrap(Trainer, "load_checkpoint", after=state_of)
            first = train.main(argv + ["--max-num-iterations", str(steps)])
            first_s = time.perf_counter() - t0
            saved = state_of(first)
            n_first = len(st.calls["takeover_iteration"])
            second = train.main(argv + ["--max-num-iterations", str(resume_to), "--resume"])
        if cuda:
            torch.cuda.synchronize()
        path_launches = dict(kernels.launches)
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else None
        rows = [json.loads(ln) for ln in (first.run_dir / "logs/events.jsonl").read_text().splitlines()]
    stats = method_run.summary(st)
    resumed_step = second.pipeline.sdf_state.step
    # where a takeover step's time goes: one traced step of the resumed run
    # (after the warm-up step device_trace takes)
    gen = torch.Generator(device=dev).manual_seed(seed + 20)
    step_trace = device_trace(lambda: second.pipeline.takeover_iteration(gen), calls=1, top=8) if cuda else None

    # the card's fusion against the CPU's on the same depth images
    fuse = st.calls["integrate_tsdf"][0]
    (cams, depth, fres, fscale), box = fuse["args"][0], fuse["args"][1]["object_aabb"]
    fused = fuse["out"].cpu()
    cpu_cams = type(cams)(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in vars(cams).items()})
    on_cpu = tsdf.integrate_tsdf(cpu_cams, depth.cpu(), fres, fscale, object_aabb=box.cpu())
    off = (fused - on_cpu).abs() > 1e-6
    fragile = tsdf_fragile(cams, depth, fres, fscale, box).cpu()
    tsdf_check = {"within": not bool((off & ~fragile).any()), "atol": 1e-6, "voxels": off.numel(),
                  "differing": int(off.sum()), "fragile": int(fragile.sum()),
                  "differing_not_fragile": int((off & ~fragile).sum()),
                  "max_abs_err": float((fused - on_cpu).abs().max())}
    (loaded_nerf, loaded_sdf, loaded_schedule), = [c["after"] for c in st.calls["load_checkpoint"]]
    take_ms = stats["takeover"]["ms_per_step"]
    pre = stats["pretrain"]
    rec = dict(
        views=views, res=res, argv=argv,
        reduced=[f"--pipeline.takeover-step {takeover} (of 2000)", f"--max-num-iterations {steps} (of 2320)",
                 f"--pipeline.distill-steps {distill} (of 2000)", f"--steps-per-eval-image {eval_every}",
                 f"--steps-per-save {save_every}", f"then --resume to {resume_to}"],
        first_run_s=first_s, total_s=total_s, pretrain=pre,
        tsdf_init=dict(stats["tsdf_init"], fused_res=fres, fused_interior_share=float((fused < 0).float().mean()),
                       card_vs_cpu=tsdf_check),
        guiding_build_s=stats["guiding_build_s"], distillations=stats["distillations"],
        takeover=dict(by_size=stats["takeover"]["by_size"], ms_per_step=take_ms[:n_first],
                      ms_per_step_resumed=take_ms[n_first:], last=stats["takeover"]["last"]),
        eval=dict(seconds=stats["eval_step_s"], rows=[r for r in rows if any(k.startswith("eval/") for k in r)],
                  launches=[c["launches"] for c in st.calls["eval_step"]]),
        save_s=stats["save_checkpoint_s"], restore_s=stats["restore_s"], bind_s=stats["resume_takeover_bind_s"],
        load_s=st.seconds("load_checkpoint"), peak_mem_gb=peak,
        # stages nest: load_checkpoint holds restore and resume_takeover_bind
        k5_launches_by_stage=stats["k5_launches_by_stage"],
        launches=path_launches, trace_one_takeover_step=step_trace)
    k5 = method_run.K5
    checks = {
        "losses_finite": method_run.finite_metrics(st)
        and all(math.isfinite(v) for r in rows for k, v in r.items() if k != "ts"),
        "rgb_loss_fell_0.7x": pre["rgb_loss_last10"] < 0.7 * pre["rgb_loss_first10"],
        "tsdf_card_vs_cpu": tsdf_check,
        "restored_nerf_bit_equal": trees_equal(loaded_nerf, saved[0]),
        "restored_sdf_bit_equal": trees_equal(loaded_sdf, saved[1]),
        "replayed_schedule_equal": loaded_schedule == saved[2],
        "distill_k5_launches_are_steps_plus_holdout": len(stats["distillations"]) == 2 and all(
            d["k5_launches"] == distill + 8 for d in stats["distillations"]),
        "eval_launched_k5": bool(st.calls["eval_step"]) and all(
            c["launches"].get(k5, 0) >= 1 for c in st.calls["eval_step"]),
        "resumed_steps_ran": resumed_step == resume_to - takeover,
    }
    return rec, checks, path_launches


def nearest_sq_f64(a, b, chunk: int = 1024):
    """For each point of a (N, 3), the squared distance to its nearest point
    of b (M, 3), in float64 numpy (|a|^2 + |b|^2 - 2 a.b: float64 keeps the
    cancellation far below the distances)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bb = (b * b).sum(1)
    return np.concatenate([np.maximum(((q * q).sum(1)[:, None] + bb[None, :] - 2.0 * q @ b.T).min(1), 0.0)
                           for q in (a[i:i + chunk] for i in range(0, len(a), chunk))])


def endtask(dev, seed: int, *, views: int = 20, relit_views: int = 10, res: int = 64, spp: int = 8,
            takeover: int = 40, steps: int = 44, mesh_res: int = 96, points: int = 20_000, extra=(), root=None):
    """The end-task tools as round 5's protocol drives them
    (scripts/endtask_run.py), cut: gen_data's composite object with banded
    albedo, `views` views at res^2 and spp (and `relit_views` under the
    rolled envmap), the ground-truth mesh at mesh_res, sdf-nerfacto through
    its train CLI at full width with the round's flags and the emitter
    pinned to K5 (the takeover at `takeover`, `steps` steps in all), eval
    (NVS, NVS with the learned denoiser, relit), every render subcommand, the exporter from the run,
    and chamfer on `points` points. Checks: transforms.json equal to a CPU
    run's (poses and object_aabb within 1e-6); the masks equal to the CPU
    render's but for at most 0.5% of the pixels (grazing rays whose hit the
    two devices' rounding decides); marching cubes of gt_sdf.npy at
    mesh_res on `dev` against the CPU (face and vertex counts equal, every
    vertex within 1e-5 of the other's nearest); chamfer(GT, GT) = 0 and the
    device chamfer against a float64 numpy nearest neighbour within 1e-6
    relative; every eval metric finite; config.json byte-identical after
    the tools; every render subcommand wrote its files. The files go to
    `root` (kept, for the `denoise` phase), or to a temporary directory.
    Returns (record, checks, the port's kernel launches over the path)."""
    import argparse as ap_

    import numpy as np

    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.exporter.marching_cubes import read_ply_or_obj, upsampled_marching_cubes
    from nerf_emitter_tpu_torch.scripts import chamfer, endtask_run, gen_data, render
    from nerf_emitter_tpu_torch.utils import exr

    d = str(dev)
    with contextlib.ExitStack() as stack:
        tmp = Path(root) if root is not None else Path(stack.enter_context(tempfile.TemporaryDirectory()))
        args = ap_.Namespace(views=views, relit_views=relit_views, res=res, spp=spp, mesh_res=mesh_res,
                             n_points=points)
        kernels.reset_launches()
        run = endtask_run.Run(dev)
        scenes = endtask_run.make_scenes(run, tmp, args, d)
        scene, _, _, gt_mesh = scenes
        flags = ["--pipeline.takeover-step", str(takeover), "--max-num-iterations", str(steps),
                 "--train.max-steps", str(steps), "--seed", str(seed), *extra]
        arm = endtask_run.run_arm(run, "baseline", tmp, *scenes, args, d, flags)
        cfg = tmp / "runs" / "prod5f" / "sdf-nerfacto" / "config.json"
        cfg_bytes = cfg.read_bytes()
        (tmp / "stroke_in.json").write_text(json.dumps({"camera_index": 0, "pixels": [[res // 2, res // 2],
                                                                                       [res // 2, res // 2 + 3]]}))
        sub_args = {"rotate-light": ["--n-frames", "2", "--video"], "camera-path": ["--n-frames", "2", "--video"],
                    "interpolate": ["--n-frames", "2"], "spiral": ["--n-frames", "2"],
                    "envmap": ["--width", "64", "--height", "32"],
                    "stroke": ["--stroke-path", str(tmp / "stroke_in.json")]}
        written = {}
        for sub in render.COMMANDS:
            dst = tmp / "render" / sub
            run.stage(f"render/{sub}", lambda sub=sub, dst=dst: render.main(
                [sub, "--load-config", str(cfg), "--output-path", str(dst), "--spp", "2", "--device", d,
                 *sub_args.get(sub, [])]))
            written[sub] = sorted(p.name for p in dst.parent.glob(f"{sub}*")) if sub == "stroke" else \
                sorted(p.name for p in dst.iterdir())
        path_launches = dict(kernels.launches)
        config_unchanged = cfg.read_bytes() == cfg_bytes

        # the CPU's transforms.json and masks of the same views (one sample:
        # the mask does not depend on the draws)
        cpu_scene = gen_data.main(["--object", "composite", "--albedo", "bands", "--width", str(res), "--height",
                                   str(res), "--spp", "1", "--path-type", "random", "--seed", "0", "--n-views",
                                   str(views), "--out", str(tmp / "cpu_scene"), "--device", "cpu"])
        t_card, t_cpu = (json.loads((p / "transforms.json").read_text()) for p in (scene, cpu_scene))
        pose_err = max(float(np.abs(np.asarray(a["transform_matrix"]) - np.asarray(b["transform_matrix"])).max())
                       for a, b in zip(t_card["frames"], t_cpu["frames"]))
        box_err = float(np.abs(np.asarray(t_card["object_aabb"]) - np.asarray(t_cpu["object_aabb"])).max())
        same_meta = {k: t_card[k] for k in t_card if k not in ("frames", "object_aabb")} == \
            {k: t_cpu[k] for k in t_cpu if k not in ("frames", "object_aabb")}
        masks = [(exr.read_exr(scene / f["file_path"])[..., 3], exr.read_exr(cpu_scene / f["file_path"])[..., 3])
                 for f in t_card["frames"]]
        differing = int(sum((a != b).sum() for a, b in masks))
        pixels = sum(a.size for a, _ in masks)

        # marching cubes of the ground truth on the card against the CPU
        gt_sdf = np.load(scene / "gt_sdf.npy")
        (v_dev, f_dev), (v_cpu, f_cpu) = (upsampled_marching_cubes(gt_sdf, mesh_res, device=x) for x in (d, "cpu"))
        vd, vc = (torch.as_tensor(v, dtype=torch.float64, device=dev) for v in (v_dev, v_cpu))
        vert_err = float(torch.maximum(chamfer.nearest_sq_dist(vd, vc, 4096).max(),
                                       chamfer.nearest_sq_dist(vc, vd, 4096).max()).sqrt())

        # chamfer: the same points give 0; the device against float64 numpy
        gt_v, gt_f = read_ply_or_obj(gt_mesh / "mesh.ply")
        run_v, run_f = read_ply_or_obj(tmp / "mesh_baseline" / "mesh.ply")
        a = chamfer.sample_mesh_points(run_v, run_f, points, seed=0)
        b = chamfer.sample_mesh_points(gt_v, gt_f, points, seed=1)
        same_points = chamfer.chamfer_distance(b, b, device=d)
        on_dev = chamfer.chamfer_distance(a, b, device=d)
        in_f64 = float(nearest_sq_f64(a, b).mean() + nearest_sq_f64(b, a).mean())
    metrics = {"nvs": arm["nvs"], "nvs_learned": arm["nvs_learned"], "relight": arm["relight"]}
    rel = abs(on_dev - in_f64) / max(in_f64, 1e-30)
    checks = {
        "transforms_card_vs_cpu": dict(pose_max_abs_err=pose_err, object_aabb_max_abs_err=box_err,
                                       intrinsics_equal=same_meta, bar=1e-6,
                                       within=same_meta and pose_err <= 1e-6 and box_err <= 1e-6),
        "masks_card_vs_cpu": dict(differing=differing, pixels=pixels, share=differing / pixels, bar=0.005,
                                  within=differing / pixels <= 0.005),
        "marching_cubes_card_vs_cpu": dict(faces=[len(f_dev), len(f_cpu)], verts=[len(v_dev), len(v_cpu)],
                                           max_vertex_err=vert_err, bar=1e-5,
                                           within=len(f_dev) == len(f_cpu) and len(v_dev) == len(v_cpu)
                                           and vert_err <= 1e-5),
        "chamfer_same_points_zero": dict(value=same_points, within=same_points == 0.0),
        "chamfer_device_vs_float64": dict(device=on_dev, float64=in_f64, rel_err=rel, bar=1e-6, within=rel <= 1e-6),
        "eval_metrics_finite": dict(within=all(math.isfinite(v) for m in metrics.values() for v in m.values())),
        "config_json_unchanged": dict(within=config_unchanged),
        "render_subcommands_wrote": dict(written=written, within=all(written.values())),
    }
    rec = dict(views=views, relit_views=relit_views, res=res, spp=spp, mesh_res=mesh_res, points=points,
               reduced=[f"{views} views at {res}^2, spp {spp} (of 60 at 128^2, spp 32)",
                        f"{relit_views} relit views (of 30)", f"mesh at {mesh_res}^3 (of 192^3)",
                        f"{points} chamfer points (of 250,000)", f"--pipeline.takeover-step {takeover} (of 2000)",
                        f"--max-num-iterations {steps} (of 2320)"],
               seconds={k: v["seconds"] for k, v in run.lines.items()}, metrics=metrics, chamfer=arm["chamfer"],
               final_scene=run.lines["baseline/train"].get("final_scene"), launches=path_launches)
    return rec, checks, path_launches


def rel_l1(x: torch.Tensor, ref: torch.Tensor) -> float:
    """tests/test_denoiser.py's relative L1 error of x against ref."""
    return float(torch.mean(torch.abs(x - ref) / (torch.abs(ref) + 1e-2)))


def noise2noise_contract(dev, seed: int) -> dict:
    """tests/test_denoiser.py::test_noise2noise_fit_denoises on `dev`, drawn
    from a torch.Generator there: a narrow predictor (radius 1, hidden 8,
    depth 2, 80 steps at lr 5e-3) fitted on three pairs of noisy buffers of
    a 32^2 image with an HDR hot spot; the denoised image's relative error
    below 0.75x the noisy input's, the hot spot above 5."""
    from nerf_emitter_tpu_torch.renderer import learned_denoise as ld

    tiny = ld.DenoiserConfig(radius=1, hidden=8, depth=2, fit_steps=80, lr=5e-3)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    y = torch.linspace(0, 1, 32, device=dev)[:, None].expand(32, 32)
    x = torch.linspace(0, 1, 32, device=dev)[None, :].expand(32, 32)
    clean = torch.stack([0.5 + 0.4 * torch.sin(6 * x), 0.3 + 0.3 * y * x, 0.2 + 0.5 * y], dim=-1).clone()
    clean[8:12, 8:12] += 25.0

    def noisy():
        return clean * (1.0 + 0.25 * torch.randn(clean.shape, generator=g, device=dev))

    normal = torch.zeros_like(clean)
    depth = torch.linspace(1, 2, 32, device=dev)[:, None, None].expand(32, 32, 1).contiguous()
    pairs = [(noisy(), noisy(), normal, depth) for _ in range(3)]
    module, loss = ld.fit_denoiser(torch.Generator(device=dev).manual_seed(seed + 2), pairs, tiny)
    test = noisy()
    with torch.no_grad():
        out = ld.apply_denoiser(module, test, normal, depth, tiny)
    err, err_noisy, hot = rel_l1(out, clean), rel_l1(test, clean), float(out[8:12, 8:12].max())
    return dict(rel_err=err, rel_err_noisy=err_noisy, ratio=err / err_noisy, ratio_bar=0.75, hot_spot=hot,
                hot_bar=5.0, loss=loss, within=err < 0.75 * err_noisy and hot > 5.0 and math.isfinite(loss))


def denoise(dev, seed: int, root: Path, *, res: int = 64, spp_ref: int = 64, apply_sizes=(128, 512),
            sdf_res: int = 32, cpu_nodes: int = 512, fg_res: int = 64, fg_spp: int = 16):
    """The learned denoiser on renders lit by K5, on the run `endtask` left
    in `root` (sdf-nerfacto at full width, the emitter pinned to K5, views
    at res^2): `render rotate-light --denoise --denoise-mode learned` (the
    fit on first use at the default DenoiserConfig: 3 views, fit_spp 8, 400
    steps), then fit_scene_denoiser timed and one denoised view; the noisy,
    bilateral and learned images' relative L1 against a spp_ref render of
    the same view; apply_denoiser's ms at apply_sizes^2 (CUDA events); what
    the fit converged to (the losses of the initial weights and of the
    identity on its last pair, the pair's unchanged pixels, the centre
    tap's weight, the depth guide's percentiles). Checks: the card's apply against the CPU's on the fitted weights (rtol
    1e-4, atol 1e-5, TF32 off); a constant image back within 1e-5
    relative; every output pixel inside its window's range; the
    noise2noise contract from a torch.Generator on the card; the loss
    finite. Then the card tools against the CPU: texture.bake_texture's
    texels on the run's export (1e-6); convert_mesh_to_sdf at sdf_res^3 on
    the GT mesh (the distance on cpu_nodes nodes, and the redistancing of
    the card's signed grid, within 1e-5; signs equal); forward_gradient at
    fg_res^2, spp fg_spp, along x (the report; the primal against a plain
    render_spp on the same draws, within the EXR's half-float rounding;
    every image finite). Returns (record, checks, the port's kernel
    launches over the denoising path)."""
    import numpy as np

    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.configs.cli import load_config
    from nerf_emitter_tpu_torch.engine.trainer import Trainer
    from nerf_emitter_tpu_torch.exporter.marching_cubes import read_ply_or_obj
    from nerf_emitter_tpu_torch.pipelines.nerf_emitter import fold_in
    from nerf_emitter_tpu_torch.renderer import learned_denoise as ld
    from nerf_emitter_tpu_torch.renderer.integrator import RenderConfig, draw_direct, render_spp
    from nerf_emitter_tpu_torch.renderer.optimize import redistance
    from nerf_emitter_tpu_torch.scripts import convert_mesh_to_sdf, forward_gradient, render, texture
    from nerf_emitter_tpu_torch.utils import exr

    cuda = dev.type == "cuda"
    cfg = root / "runs" / "prod5f" / "sdf-nerfacto" / "config.json"
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    # the denoising path: the CLI, then the fit and one denoised view
    kernels.reset_launches()
    timed("cli_rotate_light_learned", lambda: render.main(
        ["rotate-light", "--load-config", str(cfg), "--output-path", str(root / "denoised"), "--spp", "8",
         "--n-frames", "1", "--denoise", "--denoise-mode", "learned", "--device", str(dev)]))
    config = load_config(cfg)
    config.device = str(dev)
    trainer = Trainer(config)
    trainer.setup()
    trainer.load_checkpoint()
    pipe, ds = trainer.pipeline, trainer.dataset
    k5_lit = pipe._serving_use_nerf and not config.pipeline.distill_emitter
    loss = timed("fit", lambda: pipe.fit_scene_denoiser(torch.Generator(device=dev).manual_seed(17), ds))
    module, dcfg = pipe._denoiser_params, pipe._denoiser_config
    view = 1

    def view_gen():
        return torch.Generator(device=dev).manual_seed(seed + 5)

    learned = timed("denoised_view", lambda: pipe.render_camera_outputs(ds, view, view_gen(), spp=8,
                                                                          denoise="learned"))
    path_launches = dict(kernels.launches)
    cli_frame = root / "denoised" / "frame_0000.exr"

    # what the fit converged to: the loss of the initial weights and of the
    # identity (all weight on the centre tap) on the pair of the fit's last
    # step (step 399 takes pair 399 % 3 = 0: the first view's two renders,
    # on the generators fit_scene_denoiser folds in), the share of that
    # pair's pixels equal in both renders, and the centre tap's mean weight
    # on the denoised view
    g17 = torch.Generator(device=dev).manual_seed(17)
    a, b = (pipe.render_camera_outputs(ds, 0, fold_in(g17, j), spp=8) for j in (0, 1))
    with torch.no_grad():
        init_loss = float(ld.denoiser_loss(ld.init_denoiser(fold_in(g17, 6), dcfg), a["rgb"], b["rgb"],
                                           a["normal"], a["depth"], dcfg))
        identity_loss = rel_l1(a["rgb"], b["rgb"]) + rel_l1(b["rgb"], a["rgb"])
    equal_share = float((a["rgb"] == b["rgb"]).all(-1).float().mean())  # pixels the draws do not change
    noisy = pipe.render_camera_outputs(ds, view, view_gen(), spp=8)
    with torch.no_grad():
        feats = ld._features(noisy["rgb"], noisy["normal"], noisy["depth"])
        weights = module(feats)
    centre_weight = float(weights[..., weights.shape[-1] // 2].mean())
    # the depth guide: its 5th and 95th percentiles, the share of pixels at
    # the 5th's depth, and the normalised feature's largest magnitude
    depth_guide = dict(p5=float(ld._percentile(noisy["depth"], 5.0)), p95=float(ld._percentile(noisy["depth"], 95.0)),
                       share_at_p5=float((noisy["depth"] == ld._percentile(noisy["depth"], 5.0)).float().mean()),
                       feature_max_abs=float(feats[..., 7].abs().max()))

    bilateral = pipe.render_camera_outputs(ds, view, view_gen(), spp=8, denoise="bilateral")
    ref = pipe.render_camera_outputs(ds, view, torch.Generator(device=dev).manual_seed(seed + 6), spp=spp_ref)
    errors = {k: rel_l1(v["rgb"], ref["rgb"]) for k, v in
              (("noisy", noisy), ("bilateral", bilateral), ("learned", learned))}

    # apply_denoiser alone, on HDR-like inputs
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    apply_ms, inputs = {}, {}
    for size in apply_sizes:
        rgb = torch.exp(torch.randn((size, size, 3), generator=g, device=dev))
        normal = torch.nn.functional.normalize(torch.randn((size, size, 3), generator=g, device=dev), dim=-1)
        depth = 1.0 + torch.rand((size, size, 1), generator=g, device=dev)
        inputs[size] = (rgb, normal, depth)
        with torch.no_grad():
            apply_ms[size] = cuda_ms(lambda: ld.apply_denoiser(module, rgb, normal, depth, dcfg), 10) if cuda else None
    rgb, normal, depth = inputs[apply_sizes[0]]
    with torch.no_grad():
        on_card = ld.apply_denoiser(module, rgb, normal, depth, dcfg)
        on_cpu = ld.apply_denoiser(copy.deepcopy(module).cpu(), rgb.cpu(), normal.cpu(), depth.cpu(), dcfg)
        const = ld.apply_denoiser(module, torch.full_like(rgb, 3.7), normal, depth, dcfg)
        win = ld._window_stack(rgb, dcfg.radius)
    lo, hi = win.amin(dim=2), win.amax(dim=2)
    slack = 1e-5 * win.abs().amax(dim=2)
    inside = bool(((on_card >= lo - slack) & (on_card <= hi + slack)).all())
    const_err = float((const / 3.7 - 1.0).abs().max())

    # the card tools against the CPU
    mesh = root / "mesh_baseline"
    verts, faces = texture.read_obj(mesh / "mesh.obj")
    uvs, tex_size = texture.grid_atlas_uvs(len(faces), 4)
    albedo = np.load(mesh / "albedo.npy")
    tex_card = timed("texture_bake", lambda: texture.bake_texture(verts, faces, uvs, tex_size,
                                                                   texture.volume_sampler(albedo, dev), 4))
    tex_cpu = texture.bake_texture(verts, faces, uvs, tex_size, texture.volume_sampler(albedo, "cpu"), 4)
    timed("texture_cli", lambda: texture.main(
        ["--input-mesh", str(mesh / "mesh.obj"), "--albedo-volume", str(mesh / "albedo.npy"), "--roughness-volume",
         str(mesh / "roughness.npy"), "--output-dir", str(root / "textured"), "--device", str(dev)]))
    tex_files = sorted(p.name for p in (root / "textured").iterdir())

    gt_v, gt_f = read_ply_or_obj(root / "gt_mesh" / "mesh.ply")
    sdf_card = timed("convert_mesh_to_sdf", lambda: convert_mesh_to_sdf.main(
        [str(root / "gt_mesh" / "mesh.ply"), "--resolution", str(sdf_res), "--out", str(root / "gt_sdf_32.npy"),
         "--device", str(dev)]))
    xs = np.linspace(0, 1, sdf_res, dtype=np.float32)
    nodes = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    tri = np.asarray(gt_v[gt_f], np.float32)
    dist_card = convert_mesh_to_sdf.point_triangle_distance_batch(torch.as_tensor(nodes, device=dev),
                                                                  torch.as_tensor(tri, device=dev))
    pick = np.random.default_rng(seed).choice(len(nodes), cpu_nodes, replace=False)
    dist_cpu = convert_mesh_to_sdf.point_triangle_distance_batch(torch.as_tensor(nodes[pick]), torch.as_tensor(tri))
    sign = torch.as_tensor(convert_mesh_to_sdf.sign_by_parity(nodes, gt_v, gt_f), device=dev)
    signed = (sign * dist_card).reshape(sdf_res, sdf_res, sdf_res, 1)
    red_card = redistance(signed, n_iters=2 * sdf_res).cpu()
    red_cpu = redistance(signed.cpu(), n_iters=2 * sdf_res)

    fg_dir = root / "forward_gradient"
    report = timed("forward_gradient", lambda: forward_gradient.main(
        ["--axis", "x", "--resolution", str(fg_res), "--spp", str(fg_spp), "--out", str(fg_dir), "--device",
         str(dev)]))
    # the primal against a plain render of the same scene on the CLI's draws
    # (a generator seeded 0); the EXRs hold half floats
    scene, o, d = forward_gradient.setup(fg_res, None, dev)
    draws = draw_direct(scene, o.shape[0], torch.Generator(device=dev).manual_seed(0), dev, lead=(fg_spp,))
    with torch.no_grad():
        plain = render_spp(forward_gradient.apply_param(scene, "x", torch.zeros((), device=dev)), o, d, fg_spp,
                           draws=draws, config=RenderConfig(), remat=False)["rgb"].reshape(fg_res, fg_res, 3)
    fg_images = {n: exr.read_exr(fg_dir / f"{n}.exr") for n in ("primal", "forward_ad", "finite_diff")}
    del trainer, pipe
    if cuda:
        torch.cuda.empty_cache()

    checks = {
        "k5_lit": dict(within=bool(k5_lit)),
        "fit_loss_finite": dict(loss=loss, within=math.isfinite(loss)),
        "cli_frame_written": dict(within=cli_frame.exists() and bool(np.isfinite(exr.read_exr(cli_frame)).all())),
        "learned_view_finite": dict(within=all(bool(torch.isfinite(v).all()) for v in learned.values())),
        "apply_card_vs_cpu": close(on_card.cpu(), on_cpu, rtol=1e-4, atol=1e-5),
        "constant_image": dict(max_rel_err=const_err, bar=1e-5, within=const_err <= 1e-5),
        "inside_window_range": dict(within=inside),
        "noise2noise_contract": noise2noise_contract(dev, seed),
        "texture_card_vs_cpu": close(torch.as_tensor(tex_card), torch.as_tensor(tex_cpu), rtol=0.0, atol=1e-6)
        | dict(cli_files=tex_files),
        "mesh_distance_card_vs_cpu": close(dist_card[torch.as_tensor(pick, device=dev)].cpu(), dist_cpu, rtol=0.0,
                                           atol=1e-5) | dict(nodes=cpu_nodes, of=len(nodes)),
        "redistance_card_vs_cpu": close(red_card, red_cpu, rtol=0.0, atol=1e-5)
        | dict(signs_equal=bool(torch.equal(torch.sign(red_card), torch.sign(red_cpu)))),
        "convert_cli_equals_parts": dict(within=bool(np.array_equal(sdf_card, red_card.numpy()))),
        "forward_gradient_primal_vs_plain": close(torch.as_tensor(fg_images["primal"]), plain.cpu(), rtol=1e-3,
                                                  atol=1e-6),
        "forward_gradient_finite": dict(within=all(bool(np.isfinite(v).all()) for v in fg_images.values())),
    }
    checks["redistance_card_vs_cpu"]["within"] &= checks["redistance_card_vs_cpu"]["signs_equal"]
    rec = dict(res=res, fit_views=3, fit_spp=8, fit_steps=dcfg.fit_steps, config=dataclasses.asdict(dcfg),
               fit_s=secs["fit"], fit_loss=loss, init_loss=init_loss, identity_loss=identity_loss,
               pair_equal_share=equal_share, centre_tap_weight=centre_weight, depth_guide=depth_guide, seconds=secs,
               rel_l1_vs_spp64=errors,
               spp_ref=spp_ref,
               apply_ms={f"{k}^2": v for k, v in apply_ms.items()}, k5_launches=path_launches.get("mega_pipeline", 0),
               launches=path_launches, forward_gradient=dict(res=fg_res, spp=fg_spp, report=report),
               texture=dict(faces=len(faces), tex_size=tex_size),
               convert_mesh_to_sdf=dict(res=sdf_res, faces=len(gt_f), inside_nodes=int((sdf_card < 0).sum())),
               reduced=[f"views at {res}^2 (of 128^2), the endtask phase's run (40 + 4 steps of 2,320)",
                        f"the mesh-to-SDF distance held against the CPU on {cpu_nodes} of {len(nodes)} nodes",
                        f"convert_mesh_to_sdf at {sdf_res}^3 (of 128^3)"])
    return rec, checks, path_launches


VIEWER_MODES = ("rgb", "depth", "accumulation", "normal")


def viewer(dev, seed: int, *, views: int = 32, res: int = 128, takeover: int = 30, distill: int = 100,
           render_res: int = 256, render_spp: int = 4, concurrent_sizes=(64, 96, 128, 160), extra=()):
    """The web viewer beside sdf-nerfacto's train CLI, in-process: the run
    (full width, the synthetic scene of `views` at res^2, the takeover at
    step `takeover`, the cache distilled for `distill` steps) steps in a
    thread with --viewer-port on a free port while this thread is the
    client: /render in all four modes at render_res^2, spp render_spp,
    before and after the takeover; renders at `concurrent_sizes` while the
    steps run (each a new march graph, captured on a server thread beside
    the trainer's); then paused: the four modes again (their K5 launches
    counted alone), a rotated light, /scene (the light clusters),
    /metrics, /save_path; resume, pause, a last rgb view, stop. The run
    must end at the stop with a checkpoint (at the step after the last one
    run, as the reference saves it), whose restore in a new Trainer
    renders the last view's PNG within 1/255 (render_camera_outputs of the
    same pose, a generator seeded 0). Returns (record, checks, the viewer's
    launches)."""
    import threading
    import urllib.error
    import urllib.request

    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.data.datamanager import ImageDataset
    from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset
    from nerf_emitter_tpu_torch.engine.trainer import Trainer
    from nerf_emitter_tpu_torch.scripts import train
    from nerf_emitter_tpu_torch.utils.video import read_png
    from nerf_emitter_tpu_torch.viewer import server

    cuda = dev.type == "cuda"
    port = train.free_port()
    base = f"http://127.0.0.1:{port}"
    errors = []  # every answer that was not 200

    def call(path, payload=None):
        req = urllib.request.Request(base + path, data=None if payload is None else json.dumps(payload).encode(),
                                     method="GET" if payload is None else "POST")
        try:
            return urllib.request.urlopen(req, timeout=300).read()
        except urllib.error.HTTPError as e:
            errors.append(f"{path}: {e.code} {e.read()[:300]!r}")
            raise

    def metrics():
        return json.loads(call("/metrics"))

    def wait(cond, thread, timeout=900.0):
        deadline = time.time() + timeout
        while True:
            m = metrics()
            if cond(m):
                return m
            if time.time() > deadline or not thread.is_alive():
                raise AssertionError(f"viewer: the run did not reach the condition: {m}")
            time.sleep(0.05)

    def settle(thread):
        """Pause, then wait until the step in flight has ended."""
        call("/control", {"action": "pause"})
        last = metrics()["step"]
        while True:
            time.sleep(0.5)
            now = metrics()["step"]
            if now == last:
                return now
            last = now

    def png_ms(query):
        t0 = time.perf_counter()
        png = call(f"/render?{query}")
        ms = (time.perf_counter() - t0) * 1e3
        if png[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"/render?{query} did not answer a PNG")
        return png, ms

    q = f"theta=0.6&phi=0.35&radius=1.4&fov=40&spp={render_spp}&w={render_res}&h={render_res}"
    with tempfile.TemporaryDirectory() as tmp:
        scene = make_synthetic_dataset(Path(tmp) / "scene", n_views=views, width=res, height=res, seed=seed)
        argv = ["sdf-nerfacto", "--datacfg.data", str(scene), "--output-dir", str(Path(tmp) / "out"),
                "--experiment-name", "viewer", "--seed", str(seed), "--pipeline.takeover-step", str(takeover),
                "--pipeline.distill-steps", str(distill), "--max-num-iterations", "100000",
                "--steps-per-eval-image", "100000", "--steps-per-save", "100000", "--viewer-port", str(port),
                *(() if cuda else ("--device", "cpu")), *extra]
        box = {}
        thread = threading.Thread(target=lambda: box.setdefault("trainer", train.main(argv)), daemon=True)
        t_start = time.perf_counter()
        thread.start()
        while True:
            try:
                metrics()
                break
            except urllib.error.URLError:
                if not thread.is_alive() or time.perf_counter() - t_start > 600:
                    raise AssertionError("viewer: the server did not come up")
                time.sleep(0.2)
        try:
            wait(lambda m: m["step"] >= 2, thread)
            scene_nerf = json.loads(call("/scene"))
            before = {mode: png_ms(f"{q}&mode={mode}")[1] for mode in VIEWER_MODES}
            wait(lambda m: m["phase"] == "sdf" and m["step"] >= takeover + 2, thread)
            t_sdf = time.perf_counter() - t_start
            concurrent, step0 = {}, metrics()["step"]
            for i, s in enumerate(concurrent_sizes):
                concurrent[s] = png_ms(f"theta={0.3 * i}&phi=0.3&radius=1.4&spp=2&w={s}&h={s}")[1]
            steps_during = metrics()["step"] - step0
            paused_at = settle(thread)
            if cuda:
                torch.cuda.synchronize()
            kernels.reset_launches()
            after = {mode: png_ms(f"{q}&mode={mode}")[1] for mode in VIEWER_MODES}
            rgb_ms = [png_ms(f"{q}&mode=rgb")[1] for _ in range(3)]
            served = metrics()
            lit_ms = png_ms(f"{q}&mode=rgb&light=90")[1]
            if cuda:
                torch.cuda.synchronize()
            launches = dict(kernels.launches)
            scene_sdf = json.loads(call("/scene"))
            saved = call("/save_path", {"keyframes": [{"theta": 0.0, "phi": 0.3, "radius": 1.4, "fov": 40},
                                                      {"theta": 1.0, "phi": 0.3, "radius": 1.4, "fov": 40}],
                                        "n_frames": 8}).decode()
            call("/control", {"action": "resume"})
            wait(lambda m: m["step"] > paused_at and not m["paused"], thread)
            stop_at = settle(thread)
            last_png = call(f"/render?{q}&mode=rgb")
            call("/control", {"action": "stop"})
            thread.join(600)
        finally:
            if thread.is_alive():
                call("/control", {"action": "stop"})
                thread.join(600)
        trainer = box["trainer"]
        trainer.close_viewer()
        latest = trainer.ckpt.latest_step()
        camera_path = (trainer.run_dir / "camera_path.json").exists()
        config = dataclasses.replace(trainer.config, viewer_port=0)
        del trainer, box
        restored = Trainer(config)
        restored.setup()
        restored.load_checkpoint(latest)
        cams = server.orbit_cameras(0.6, 0.35, 1.4, render_res, render_res, fov_deg=40.0, device=dev)
        ds = ImageDataset(cameras=cams, images=restored.dataset.images[:1])
        out = restored.pipeline.render_camera_outputs(ds, 0, torch.Generator(device=dev).manual_seed(0),
                                                      spp=render_spp)
        (Path(tmp) / "live.png").write_bytes(last_png)
        (Path(tmp) / "restored.png").write_bytes(server.visualize(out["rgb"].float().cpu().numpy(), "rgb"))
        live = read_png(Path(tmp) / "live.png").astype(int)
        again = read_png(Path(tmp) / "restored.png").astype(int)
        del restored, out
    png_diff = int(abs(live - again).max())
    rec = dict(views=views, res=res, takeover=takeover, distill=distill, render=f"{render_res}^2 spp {render_spp}",
               to_takeover_s=t_sdf, render_ms_before_takeover=before, render_ms_after_takeover=after,
               render_ms_rgb=rgb_ms, server_render_ms=served["render_ms"], lock_wait_ms=served["lock_wait_ms"],
               render_ms_light_rotated=lit_ms, concurrent_render_ms=concurrent,
               steps_during_concurrent_renders=steps_during, paused_at=paused_at, stopped_at=stop_at,
               checkpoint=latest, light_clusters=len(scene_sdf.get("lights", {}).get("positions", [])),
               launches=launches, png_max_diff_restored=png_diff, errors=errors,
               reduced=[f"{views} views at {res}^2", f"--pipeline.takeover-step {takeover} (of 2000)",
                        f"--pipeline.distill-steps {distill} (of 2000)", "stopped from the viewer"])
    checks = {
        "no_render_errors": not errors,
        "scene_before_takeover_has_no_lights": scene_nerf.get("phase") != "nerf" or "lights" not in scene_nerf,
        "scene_after_takeover_has_lights": scene_sdf.get("phase") == "sdf" and rec["light_clusters"] > 0,
        "metrics_paused_in_sdf": served["paused"] and served["phase"] == "sdf" and len(served["losses"]) > 0,
        "camera_path_written": camera_path and "camera_path.json" in saved,
        # /metrics shows the last step run; the stop saves at the next
        "stopped_with_a_checkpoint": latest == stop_at + 1,
        "restored_view_within_1_of_255": png_diff <= 1,
        "viewer_launched_k5": launches.get("mega_pipeline", 0) >= 1 if cuda else True,
    }
    return rec, checks, launches


@contextlib.contextmanager
def timed_collectives(dist, sink: list):
    """Inside: torch.distributed's all_reduce and broadcast (the mesh
    module's collectives) each timed, the device synchronised around the
    call, its milliseconds appended to `sink`."""
    real = {name: getattr(dist, name) for name in ("all_reduce", "broadcast")}
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def timed(fn):
        def call(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    for name, fn in real.items():
        setattr(dist, name, timed(fn))
    try:
        yield sink
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def worst(checks: dict) -> dict:
    """The largest error of a set of `close` checks, and whether all hold."""
    name = max(checks, key=lambda k: checks[k]["max_abs_err"])
    return dict(worst=name, max_abs_err=checks[name]["max_abs_err"], max_rel_err=checks[name]["max_rel_err"],
                rtol=checks[name]["rtol"], atol=checks[name]["atol"], held=len(checks),
                within=all(c["within"] for c in checks.values()))


def _multi_gpu_rank(rank: int, world: int, port: int, seed: int, out_dir: str, cfg: dict) -> None:
    """One rank of the multi_gpu phase (spawned): (a) the NeRF train step,
    (b) a K5-lit takeover step and (c) the emitter query, each on rank 0
    alone and then split over the ranks, on this rank's device; (c) also
    the query gradient's independence of the batch. Saves its record to
    out_dir/rank<r>.pt."""
    os.environ.update(NERF_EMITTER_COORDINATOR=f"127.0.0.1:{port}", NERF_EMITTER_NUM_PROCESSES=str(world),
                      NERF_EMITTER_PROCESS_ID=str(rank), PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.data.datamanager import ImageDataset
    from nerf_emitter_tpu_torch.engine import train_loop as TT
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
    from nerf_emitter_tpu_torch.parallel import mesh as pm
    from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn
    from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import SdfOptState, TakeoverConfig, build_sdf_optimizer
    from nerf_emitter_tpu_torch.pipelines.sdf_optimizer import make_sdf_train_step
    from nerf_emitter_tpu_torch.renderer.emitters import VMFMixture
    from nerf_emitter_tpu_torch.renderer.optimize import get_opt_config
    from nerf_emitter_tpu_torch.renderer.scene import SdfScene

    cuda = cfg["device"] == "cuda"
    if cuda:
        kernels.build()
    assert pm.maybe_initialize_distributed(cfg["device"])
    mesh = pm.make_mesh(device_type=cfg["device"])
    dev = mesh.device
    rec = dict(rank=mesh.rank, world=mesh.world_size, backend=mesh.backend, device=str(dev))
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ms_of = cuda_ms if cuda else (lambda fn, reps: float("nan"))

    def model_of():
        torch.manual_seed(seed)
        return NerfactoModel(AABB, num_nerf_samples=cfg["samples"][2], num_proposal_samples=cfg["samples"][:2],
                             num_cameras=128, appearance_embedding_dim=32, implementation="freq", device=dev)

    def alone_then_all(run, runs_alone=1):
        """run(mesh or None) -> (tensors, extras): `runs_alone` one-rank
        runs on rank 0 alone (the ranks share the card's memory and time;
        the others wait), then the sharded run on every rank. Returns
        (rank 0's one-rank tensors on every rank, the repeats' tensors on
        rank 0, rank 0's one-rank extras, this rank's sharded tensors and
        extras)."""
        alone = []
        for _ in range(runs_alone if mesh.is_main else 0):
            alone.append(run(None))
        pm.barrier(mesh)
        sharded, extras = run(mesh)
        one = alone[0][0] if alone else {k: torch.zeros_like(v) for k, v in sharded.items()}
        pm.replicated(one, mesh)
        return one, [a[0] for a in alone[1:]], alone[0][1] if alone else {}, sharded, extras

    def timed_run(fn):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with timed_collectives(pm.dist, []) as coll_ms:
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
        return out, dict(ms=ms, collective_ms=sum(coll_ms), collectives=len(coll_ms),
                         launches=dict(kernels.launches),
                         peak_gb=torch.cuda.max_memory_allocated() / 2**30 if cuda else None)

    def held(got, want, names):
        return worst({k: close(got[k], want[k], rtol=2e-4, atol=1e-6) for k in names})

    # (a) the NeRF train step at sdf-nerfacto's batch
    g = torch.Generator().manual_seed(seed)
    cams = ring_cameras(cfg["views"], cfg["res"], dev)
    ds = ImageDataset(cameras=cams, images=torch.rand((cfg["views"], cfg["res"], cfg["res"], 3), generator=g).to(dev))
    init = {k: v.clone() for k, v in model_of().state_dict().items()}

    def nerf_step(m):
        model = model_of()
        tc = TT.TrainConfig(num_rays_per_batch=cfg["rays"], data_axis=None if m is None else pm.DATA_AXIS)
        for _ in range(2):  # a warm-up step, then the step held, from the same start
            model.load_state_dict(init)
            state, opt = TT.create_train_state(model, tc, m)
            step = TT.make_train_step(model, tc, opt, mesh=m)
            gen = torch.Generator(device=dev).manual_seed(seed)
            metrics, extras = timed_run(lambda: step(state, ds, gen))
        out = {f"p.{k}": p.detach().clone() for k, p in model.named_parameters()}
        return out | {"loss": metrics["loss"].reshape(1).detach()}, extras

    one, _, one_x, sh, sh_x = alone_then_all(nerf_step)
    params = [k for k in one if k.startswith("p.")]
    rec["nerf_step"] = {
        "rays": cfg["rays"], "loss": [float(one["loss"]), float(sh["loss"])],
        "loss_rel_err": float((sh["loss"] - one["loss"]).abs() / one["loss"].abs()),
        "params": held(sh, one, params), "replica_max_diff": pm.max_replica_difference([sh[k] for k in params], mesh),
        "ms": {"one_rank_alone": one_x.get("ms"), "sharded": sh_x["ms"]}, "collective_ms": sh_x["collective_ms"],
        "collectives": sh_x["collectives"], "peak_gb": {"one_rank_alone": one_x.get("peak_gb"),
                                                        "sharded": sh_x["peak_gb"]}}
    del one, sh, ds, init

    # (b) one K5-lit takeover step at prod5f's shapes
    model = model_of()
    pm.replicated(model, mesh)
    recipe = get_opt_config(TAKEOVER_RECIPE)
    size = cfg["size"]
    gen = torch.Generator().manual_seed(seed + 1)
    k = 8
    vmf = VMFMixture(positions=(0.5 + 0.6 * torch.randn((k, 3), generator=gen)).to(dev),
                     weights=torch.rand((k,), generator=gen).to(dev) + 0.1, stds=torch.full((k,), 0.3, device=dev))
    cams = ring_cameras(4, size, dev, focal=size)
    gts = torch.rand((4, size, size, 3), generator=gen).to(dev)
    masks = (torch.rand((4, size, size, 1), generator=gen) > 0.5).float().to(dev)
    fn_of = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, detach_nerf=True)
    tk = TakeoverConfig(spp=cfg["spp"], spp_per_batch=min(8, cfg["spp"]), image_height=size, image_width=size,
                        scene_scale=1.0, spp_attached=cfg["spp_attached"])
    cam = torch.arange(cfg["batch"], device=dev)
    shape = {}

    def takeover_step(m):
        scene = SdfScene.create(sdf_res=recipe.init_res, tex_res=recipe.tex_res, bsdf_type=recipe.bsdf_type,
                                init_radius=0.25, device=dev).replace(guiding=vmf)
        tx = GradProbe(build_sdf_optimizer(recipe))
        step = make_sdf_train_step(recipe, tk, tx, render_config=takeover_render_config(),
                                   emitter_for_camera=lambda c, r: fn_of(camera_index=c, rot_id=r), mesh=m,
                                   data_axis=None if m is None else pm.DATA_AXIS)
        shape.update(bands=step.n_grad_bands, detached_chunks=step.chunks)
        state = SdfOptState(step=0, scene=scene, opt_state=tx.init(scene))
        g_step = torch.Generator(device=dev).manual_seed(seed + 2)
        (new, metrics), extras = timed_run(lambda: step(state, cams, cam, gts[cam], masks[cam], g_step))
        return {"loss": torch.tensor([float(metrics["loss"])], device=dev), "sdf": new.scene.sdf,
                "albedo": new.scene.albedo, "g.sdf": new.opt_state[1]["sdf"],
                "g.albedo": new.opt_state[1]["albedo"]}, extras

    one, again, one_x, sh, sh_x = alone_then_all(takeover_step, runs_alone=2)
    rec["takeover_step"] = {
        "size": size, "batch": cfg["batch"], "spp": cfg["spp"], "spp_attached": cfg["spp_attached"], **shape,
        "loss": [float(one["loss"]), float(sh["loss"])],
        "loss_rel_err": float((sh["loss"] - one["loss"]).abs() / one["loss"].abs()),
        "params": held(sh, one, ("sdf", "albedo")), "grads": held(sh, one, ("g.sdf", "g.albedo")),
        # the one-rank step against itself, run again on rank 0: the card's
        # own run-to-run spread (atomic adds in the grids' backward)
        "one_rank_repeat": {"params": held(again[0], one, ("sdf", "albedo")),
                            "grads": held(again[0], one, ("g.sdf", "g.albedo"))} if again else None,
        "replica_max_diff": pm.max_replica_difference([sh["sdf"], sh["albedo"]], mesh),
        "ms": {"one_rank_alone": one_x.get("ms"), "sharded": sh_x["ms"]}, "collective_ms": sh_x["collective_ms"],
        "peak_gb": {"one_rank_alone": one_x.get("peak_gb"), "sharded": sh_x["peak_gb"]},
        "launches": sh_x["launches"], "launches_one_rank": one_x.get("launches")}
    del one, again, sh
    if cuda:
        torch.cuda.empty_cache()

    # (c) the emitter query on a replicated batch, split over the ranks
    x_unit, d = emitter_rays(cfg["query_rays"], seed, dev)
    alone = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0)(camera_index=0)
    split = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, mesh=mesh, data_axis=pm.DATA_AXIS)(camera_index=0)
    with torch.no_grad():
        want = alone(x_unit, d)
        kernels.reset_launches()
        got = split(x_unit, d)
        sync()
        q_launches = dict(kernels.launches)
        q_ms = {"k5_alone": ms_of(lambda: alone(x_unit, d), 3), "sharded": ms_of(lambda: split(x_unit, d), 3)}
    rec["query"] = dict(rays=cfg["query_rays"], max_abs_diff=float((got - want).abs().max()), shape=list(got.shape),
                        launches=q_launches, ms=q_ms)
    # on rank 0 alone: a ray's gradient through the kernel query does not
    # depend on the batch it is asked in (2 x query_rays rays, then in halves;
    # the backward recomputes in chunks of mega_query.RECOMPUTE_RAYS)
    if mesh.is_main:
        lit = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, detach_nerf=True)(camera_index=0)
        x2, d2 = emitter_rays(2 * cfg["query_rays"], seed + 3, dev)
        w2 = torch.rand((x2.shape[0], 3), generator=torch.Generator().manual_seed(seed)).to(dev)

        def ray_grads(rows):
            xs, ds = x2[rows].clone().requires_grad_(), d2[rows].clone().requires_grad_()
            return torch.cat(torch.autograd.grad((lit(xs, ds) * w2[rows]).sum(), [xs, ds]), dim=1)

        whole = ray_grads(slice(None))
        half = cfg["query_rays"]
        halves = torch.cat([ray_grads(slice(0, half)), ray_grads(slice(half, None))])
        rec["query"]["grad_rows_vs_halves"] = dict(rays=2 * half, max_abs_diff=float((whole - halves).abs().max()),
                                                   max_abs=float(whole.abs().max()))
        del whole, halves
    pm.barrier(mesh)
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))
    pm.barrier(mesh)
    torch.distributed.destroy_process_group()


def _cli_ranks(world: int, port: int, argv: list, timeout: float, boot=None) -> list:
    """The train CLI in `world` processes joined through NERF_EMITTER_*;
    returns each rank's (exit code, output). A rank still running at the
    timeout is killed (exit code -9). `boot`: Python source run instead of
    `-m nerf_emitter_tpu_torch.scripts.train` (it gets the same argv)."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = ["-m", "nerf_emitter_tpu_torch.scripts.train"] if boot is None else ["-c", boot]
    with tempfile.TemporaryDirectory() as logs:
        procs = []
        for rank in range(world):
            # the host's cores shared out: gloo's ranks oversubscribed stall
            env = dict(os.environ, NERF_EMITTER_COORDINATOR=f"127.0.0.1:{port}",
                       NERF_EMITTER_NUM_PROCESSES=str(world), NERF_EMITTER_PROCESS_ID=str(rank), PYTHONPATH=here,
                       OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // world)))
            with open(Path(logs) / f"{rank}.log", "w") as log:
                procs.append(subprocess.Popen([sys.executable, *cmd, *argv], cwd=here, env=env, text=True,
                                              stdout=log, stderr=subprocess.STDOUT))
        deadline = time.time() + timeout
        try:
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [(p.returncode, (Path(logs) / f"{rank}.log").read_text()) for rank, p in enumerate(procs)]


def multi_gpu(dev, seed: int, *, world: int = 2, views: int = 16, res: int = 256, rays: int = TRAIN_RAYS,
              size: int = 128, batch: int = 2, spp: int = 16, spp_attached: int = 8, query_rays: int = RAYS,
              samples=(*SAMPLES, NERF_SAMPLES), cli_views: int = 16, cli_res: int = 64, extra=(), boot=None):
    """Training across ranks on the one card: `world` ranks joined over
    gloo (NCCL refuses two ranks on one device), spawned with
    torch.multiprocessing; each holds against the one-rank result on the
    card, computed in the same process: (a) the NeRF train step at `rays`
    rays (full width; loss rtol 1e-5, parameters rtol 2e-4, atol 1e-6:
    tests/test_multichip.py's bars); (b) one K5-lit takeover step at
    prod5f's shapes (size^2, `batch` images, spp `spp`, `spp_attached`
    attached) at the same bars, with each rank's K5 and vjp launches; (c)
    the emitter query on `query_rays` replicated rays split over the ranks
    against K5 alone (max abs difference 1e-6: rows are independent), and
    on rank 0 the query's ray gradients at 2 x query_rays rays against the
    same rays asked in halves (equal: ROADMAP Queue 3 item 10). Then
    the train CLI through NERF_EMITTER_* in `world` processes (both ranks'
    losses equal, rank 0 alone writing events and checkpoints), and in one
    process, a world of one rank on NCCL. Two ranks on one card measure
    correctness and the collectives' overhead, not a speed-up across
    cards. On the CPU (`dev` cpu, for a rehearsal) the ranks and the CLI
    run there (the CLI with `extra` flags, through `boot`). Returns
    (record, checks, the sharded runs' launches summed over the ranks)."""
    import re

    from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset
    from nerf_emitter_tpu_torch.scripts.train import free_port

    cfg = dict(views=views, res=res, rays=rays, size=size, batch=batch, spp=spp, spp_attached=spp_attached,
               query_rays=query_rays, samples=tuple(samples), device=dev.type)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_multi_gpu_rank, args=(world, free_port(), seed, tmp, cfg), nprocs=world,
                                    join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(world)]
        ranks_s = time.perf_counter() - t0

        scene = make_synthetic_dataset(Path(tmp) / "scene", n_views=cli_views, width=cli_res, height=cli_res,
                                       seed=seed)

        def argv(name):
            return ["sdf-nerfacto", "--datacfg.data", str(scene), "--output-dir", str(Path(tmp) / "out"),
                    "--experiment-name", name, "--seed", str(seed), "--pipeline.takeover-step", "10",
                    "--max-num-iterations", "21", "--pipeline.distill-steps", "20", "--steps-per-eval-image", "15",
                    "--steps-per-save", "15", *(() if dev.type == "cuda" else ("--device", "cpu")), *extra]

        t1 = time.perf_counter()
        cli = _cli_ranks(world, free_port(), argv("ranks"), timeout=400, boot=boot)
        cli_s = time.perf_counter() - t1
        run_dir = Path(tmp) / "out/ranks/sdf-nerfacto"
        rows = ([json.loads(ln) for ln in (run_dir / "logs/events.jsonl").read_text().splitlines()]
                if (run_dir / "logs/events.jsonl").exists() else [])
        ckpts = sorted(p.name for p in (run_dir / "checkpoints").iterdir()) if (run_dir / "checkpoints").exists() \
            else []
        t2 = time.perf_counter()
        (nccl_rc, nccl_out), = _cli_ranks(1, free_port(), argv("nccl"), timeout=300, boot=boot)
        nccl_s = time.perf_counter() - t2
        nccl_ckpt = (Path(tmp) / "out/nccl/sdf-nerfacto/checkpoints/21").exists()
    train_losses = {r["step"]: r["loss"] for r in rows if "loss" in r}
    printed = [{int(s): float(v) for r, s, v in re.findall(r"^rank (\d+) step (\d+) loss (\S+)$", out, re.M)}
               for _, out in cli[1:]]
    launches = {}
    for r in ranks:
        for src in (r["takeover_step"]["launches"], r["query"]["launches"]):
            for k, v in src.items():
                launches[k] = launches.get(k, 0) + v
    rec = dict(world=world, backend=[r["backend"] for r in ranks], devices=[r["device"] for r in ranks],
               ranks_s=ranks_s, per_rank=[{k: r[k] for k in ("nerf_step", "takeover_step", "query")} for r in ranks],
               cli=dict(seconds=cli_s, rcs=[rc for rc, _ in cli], losses_rank0=train_losses, losses_printed=printed,
                        rows=len(rows), checkpoints=ckpts, tail=[out[-1500:] for rc, out in cli if rc != 0]),
               nccl=dict(seconds=nccl_s, rc=nccl_rc, checkpoint=nccl_ckpt,
                         tail=nccl_out[-1500:] if nccl_rc != 0 else None),
               note="two ranks share one card: correctness and the collectives' overhead, no speed-up across cards",
               reduced=[f"(a) {views} views at {res}^2 of random images", "(b) random GT at prod5f's shapes",
                        f"the CLI runs: {cli_views} views at {cli_res}^2, 10 + 11 steps"])
    per_step = [r["nerf_step"] for r in ranks]
    per_take = [r["takeover_step"] for r in ranks]
    checks = {
        "gloo_on_one_card": all(r["backend"] == "gloo" for r in ranks),
        "nerf_step_collectives_ran": all(s["collectives"] > 0 for s in per_step),
        "nerf_step_loss_rtol_1e-5": all(s["loss_rel_err"] <= 1e-5 for s in per_step),
        "nerf_step_params": all(s["params"]["within"] for s in per_step),
        "nerf_step_replicas_equal": all(s["replica_max_diff"] == 0.0 for s in per_step),
        "takeover_loss_rtol_1e-5": all(s["loss_rel_err"] <= 1e-5 for s in per_take),
        "takeover_params": all(s["params"]["within"] for s in per_take),
        "takeover_replicas_equal": all(s["replica_max_diff"] == 0.0 for s in per_take),
        "takeover_k5_and_vjp_on_every_rank": dev.type != "cuda" or all(
            s["launches"].get("mega_pipeline", 0) >= 1 and s["launches"].get("field_composite_vjp", 0) >= 1
            for s in per_take),
        "query_within_1e-6": all(r["query"]["max_abs_diff"] <= 1e-6 for r in ranks),
        "query_grad_rows_independent_of_the_batch": ranks[0]["query"]["grad_rows_vs_halves"]["max_abs_diff"] == 0.0,
        "cli_ranks_exit_0": all(rc == 0 for rc, _ in cli),
        "cli_losses_equal_on_every_rank": bool(train_losses) and all(p == train_losses for p in printed),
        "cli_rank0_alone_writes": sorted(train_losses) == [0, 10, 20] and len([r for r in rows if "loss" in r]) == 3
        and ckpts == ["21"] and "(gloo)" in cli[0][1],
        "nccl_one_rank": nccl_rc == 0 and nccl_ckpt
        and f"process group: {'nccl' if dev.type == 'cuda' else 'gloo'}" in nccl_out,
    }
    return rec, checks, launches


def k3_then_k4(model, rays, camera_index: int = 0) -> torch.Tensor:
    """The kernel query's answer (n, 3) to `rays` (a RayBundle) with the
    object box carved out, through K3, then K4 on K3's bins, in place of
    K5, whose answer equals it bit for bit: the weights as the query hands
    them to its kernels (f-major first-layer rows), the rays in their
    (3, N) / (1, N) layout. A ray's answer does not depend on the rays
    beside it, so the rows are not padded to whole tiles."""
    from nerf_emitter_tpu_torch.ops import fused_field as ff
    from nerf_emitter_tpu_torch.ops import mega_query as mq

    p = ff.named_params(model)
    cfg = ff._QueryConfig(model, OBJECT_BOX, model.device)
    (s0, s1), s2 = cfg.n_prop, cfg.n_nerf
    mlps = [ff._mlp_params(p, k) for k in ("proposal_0.mlp", "proposal_1.mlp", "field.base_mlp", "field.head_mlp")]
    f0, f1, f = (ff._freqs_of(ws[0]) for ws, _ in mlps[:3])
    (ws0, bs0), (ws1, bs1), (bws, bbs), (hws, hbs) = mlps
    box = dict(aabb_lo=cfg.aabb_lo, aabb_inv_ext=cfg.aabb_inv_ext, disable_box=cfg.dbox, avg_density=1.0)
    rows = [t.T.contiguous() for t in (rays.origins, rays.directions, rays.nears, rays.fars)]
    with torch.no_grad():
        sbins = mq.proposal_bins(*rows, ff.permute_first(ws0, f0), bs0, ff.permute_first(ws1, f1), bs1, s0=s0,
                                 s1=s1, s2=s2, freqs0=f0, freqs1=f1, **box)
        rgb = mq.field_composite(sbins, *rows, cfg.embedding(p, camera_index, model.device).contiguous(),
                                 ff.permute_first(bws, f), bbs, hws, hbs, s2=s2, freqs=f, hdr=cfg.hdr,
                                 rgb_bias=cfg.rgb_bias, **box)
    return rgb.T


def trees_equal(a, b) -> bool:
    """Two state trees (engine/checkpoints.py's) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    return a == b


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nerf_emitter_tpu_torch import kernels
    from nerf_emitter_tpu_torch.cameras.rays import RayBundle
    from nerf_emitter_tpu_torch.fields.rotater import Rotater
    from nerf_emitter_tpu_torch.guiding.gmm import fit_spherical_gmm
    from nerf_emitter_tpu_torch.guiding.light_pc import compensate_pc, extract_light_point_cloud
    from nerf_emitter_tpu_torch.guiding.path_guiding import VMFGuiding
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
    from nerf_emitter_tpu_torch.ops import fused_field as ff
    from nerf_emitter_tpu_torch.ops import mega_query as mq
    from nerf_emitter_tpu_torch.ops import resample as rs
    from nerf_emitter_tpu_torch.ops.colliders import aabb_far_intersect_collider
    from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn
    from nerf_emitter_tpu_torch.scripts import profile_kernel_a, profile_query, profile_resample
    from nerf_emitter_tpu_torch.scripts.profiling import ProfileSetup, device_trace
    from nerf_emitter_tpu_torch.serving.distill import DistillConfig, distill_emitter, make_student_emitter_fn_of
    from nerf_emitter_tpu_torch.utils import coords
    from nerf_emitter_tpu_torch.utils.coords import unit_to_world

    # f32 comparisons on the card run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_script = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # ---- phase 1: build
    info = kernels.build()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in info["ptxas"].items()}
    emit(dict(phase="build", card=card, seconds=info["seconds"], dir=info["dir"],
              compiled=info["compiled"], ptxas=ptxas))

    # ---- the model at full sdf-nerfacto width, random weights from the seed
    torch.manual_seed(args.seed)
    model = NerfactoModel(
        AABB, num_nerf_samples=NERF_SAMPLES, num_proposal_samples=SAMPLES, num_cameras=128,
        appearance_embedding_dim=32, implementation="freq", device=dev,
    )
    p = ff.named_params(model)
    cfg = dict(aabb_lo=tuple(x for x in AABB[0]), aabb_inv_ext=(1.0 / 3.0,) * 3,
               disable_box=OBJECT_BOX, avg_density=1.0)
    n, nc = RAYS, CHECK_RAYS
    s0, s1 = SAMPLES
    s2 = NERF_SAMPLES

    def ray_bundle(far, m=n):
        """The first m of the main path's rays as make_nerf_emitter_fn
        builds them (camera 0)."""
        rays = RayBundle(
            origins=unit_to_world(x_unit[:m], 1.0), directions=d[:m],
            pixel_area=torch.full((m, 1), 1e-4, device=dev), nears=torch.zeros((m, 1), device=dev),
            fars=torch.full((m, 1), far, device=dev),
            camera_indices=torch.zeros((m, 1), dtype=torch.long, device=dev),
        )
        return aabb_far_intersect_collider(rays, torch.tensor(OBJECT_BOX, device=dev), far=far)

    def ray_rows(far):
        """The main path's rays in the kernels' (3, N) / (1, N) layout."""
        rays = ray_bundle(far)
        return [t.T.contiguous() for t in (rays.origins, rays.directions, rays.nears, rays.fars)]

    def split(rgb, aux):
        """(3, N) answer and K4's (4, N) aux -> the well-posed foreground
        sum(w rgb) (3, N) and the accumulation (N,)."""
        return rgb - aux[1:] * (1.0 - aux[:1]), aux[0]

    # At the emitter's far = 1e3 the last (background) sample sits ~500
    # units out, where the spacing warp 1 / (2 - 2 s) has a slope of ~2e6:
    # one ulp of a spacing bin moves that sample by ~0.1 units, which
    # scrambles the top octaves of its encoding and so its colour. Any two
    # implementations of the sampler (kernel and twin, kernel query and
    # model forward) then disagree on that colour by several %; the K4
    # phase measures how far a 1-ulp shift of the bins moves the answer.
    # That colour enters the answer only as the background term
    # rgb_last (1 - acc). The rest, the foreground sum(w rgb) and the
    # accumulation, is well posed on given bins, but not across samplers:
    # the bins near the scene-box face are wide at far = 1e3, and a shift
    # of a bin edge by the samplers' ~1e-4 of the spacing range can move
    # a midpoint across the face and flip its keep mask. So at far = 1e3
    # the main path's answer (K5) is held through K3 and K4: it equals K4
    # on K3's bins (atol 1e-6), which equals the two-kernel query's answer
    # bit for bit; K3's bins agree with its twin (atol 2e-3), and on those
    # bins K4's foreground and accumulation agree with its twin within 1%
    # and its whole answer within 10% (so do K5's with its own twin). At far = 4,
    # which keeps the last sample near the scene, the query is held to the
    # model forward within 3%; at far = 1e3 that comparison is reported.
    x_unit, d = emitter_rays(n, args.seed, dev)
    o_t, d_t, near_t, far_t = ray_rows(1e3)
    rows4 = ray_rows(4.0)

    # ---- phase 2: each kernel against its twin at the main path's shapes
    results = {}
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)

    @torch.no_grad()
    def kernel_phase(name, replaces, source, run, twin, compare, flops, nbytes, reps, **extra):
        out_k, out_t = run(), twin()
        torch.cuda.synchronize()
        checks = compare(out_k, out_t)  # a check with held=False is reported only
        held = [c for c in checks.values() if c.get("held", True)]
        del out_t
        ms = cuda_ms(run, reps)
        plain_ms = cuda_ms(twin, 1)
        b_ms, b_by = bound_ms(flops, nbytes)
        res = dict(name=name, route="cuda", source=source, replaces=replaces, checks=checks,
                   max_abs_err=max(c["max_abs_err"] for c in held), ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   flops=flops, bytes=nbytes, **extra)
        emit(dict(phase="kernel", **res))
        if not all(c["within"] for c in held):
            raise AssertionError(f"{name}: kernel disagrees with its twin: {checks}")
        results[name] = res
        del out_k
        torch.cuda.empty_cache()

    def design(source, kernel, occupancy=None, smem_host=None, rows=None, rays=None):
        """A kernel's ptxas report and, given its launcher's occupancy, its
        launch shape (for K1 and K2, given the rows, their 128-row passes
        and persistent grid; for K3, given the rays, its persistent grid
        over 8-ray groups); its shared memory as the launcher sizes it must
        equal the host's count and fit a block."""
        out = dict(ptxas=ptxas_of(info["ptxas"].get(source, ""), kernel))
        if occupancy is not None:
            per_sm, sms, smem = occupancy
            if smem != smem_host or smem > kernels.SMEM_LIMIT:
                raise AssertionError(f"{kernel}: shared memory {smem} (host count {smem_host})")
            out |= dict(blocks_per_sm=per_sm, sms=sms, smem_bytes=smem)
            if rows is not None:
                out |= dict(rows=rows, passes=kernels.row_passes(rows),
                            grid=kernels.persistent_grid(rows, per_sm, sms))
            if rays is not None:
                out |= dict(rays=rays, groups=-(-rays // kernels.FIELD_RAYS),
                            grid=min(-(-rays // kernels.FIELD_RAYS), per_sm * sms))
        return out

    def first(t, m=ODD_RAYS):
        return t[:, :m].contiguous()

    # K1 at both proposal levels, as the backward's recompute route runs it
    # (one launch each): 2^16 x 256 samples with F=4 and 2^16 x 96 samples
    # with F=6; also on the first 1003 x 256 and 1003 x 96 rows (the latter
    # ends in a part-filled pass) and 1003 rows (a part-filled warpgroup tile)
    ws0, bs0 = ff._mlp_params(p, "proposal_0.mlp")
    ws1, bs1 = ff._mlp_params(p, "proposal_1.mlp")
    levels = [(torch.rand((3, n * s), generator=g, device=dev) * 3.2 - 1.6, ws, bs, dict(num_freqs=f, **cfg))
              for s, ws, bs, f in ((s0, ws0, bs0, 4), (s1, ws1, bs1, 6))]

    def k1_checks(a, b):
        # f32 sums in another order can flip a bf16 rounding of a hidden unit
        out = {f"density_level{i}": close(ai, bi, rtol=1e-2, atol=1e-4) for i, (ai, bi) in enumerate(zip(a, b))}
        with torch.no_grad():
            for i, m in ((0, ODD_RAYS * s0), (1, ODD_RAYS * s1), (0, ODD_RAYS)):
                pos, ws, bs, kw = levels[i]
                part = first(pos, m)
                out[f"density_level{i}_{m}_rows"] = close(ff._launch_density(part, ws, bs, **kw),
                                                          ff._plain_density(part, ws, bs, **kw),
                                                          rtol=1e-2, atol=1e-4)
        return out

    kernel_phase(
        "fused_density", "nerf_emitter_tpu/ops/fused_field.py:236",
        "nerf_emitter_tpu_torch/csrc/fused_density.cu",
        lambda: [ff._launch_density(pos, ws, bs, **kw) for pos, ws, bs, kw in levels],
        lambda: [ff._plain_density(pos, ws, bs, **kw) for pos, ws, bs, kw in levels],
        k1_checks,
        sum(2.0 * pos.shape[1] * mlp_macs(ws) for pos, ws, _, _ in levels),
        sum(pos.shape[1] * 16.0 for pos, _, _, _ in levels), reps=3,
        design={f"level{i}": design("fused_density", "density_kernel", kernels.fused_density_occupancy(),
                                    kernels.density_smem_bytes(), rows=pos.shape[1])
                for i, (pos, _, _, _) in enumerate(levels)},
    )
    del levels

    # K2 at the field shape: 2^16 x 48 samples, F=10
    m2 = n * s2
    pos2 = (torch.rand((3, m2), generator=g, device=dev) * 3.2 - 1.6).contiguous()
    dirs2 = torch.randn((3, m2), generator=g, device=dev)
    dirs2 = (dirs2 / dirs2.norm(dim=0, keepdim=True)).contiguous()
    bws, bbs = ff._mlp_params(p, "field.base_mlp")
    hws, hbs = ff._mlp_params(p, "field.head_mlp")
    emb = p["field.appearance_embedding.weight"][0].contiguous()
    k2 = dict(num_freqs=10, hdr=True, rgb_bias=0.0, **cfg)

    def k2_checks(a, b):
        out = {"density": close(a[0], b[0], rtol=1e-2, atol=1e-4), "rgb": close(a[1], b[1], rtol=1e-2, atol=1e-4)}
        m = ODD_RAYS * s2  # ends in a part-filled pass
        part = (first(pos2, m), first(dirs2, m), emb, bws, bbs, hws, hbs)
        with torch.no_grad():
            pa, pb = ff._launch_field(*part, **k2), ff._plain_field(*part, **k2)
        out |= {f"density_{m}_rows": close(pa[0], pb[0], rtol=1e-2, atol=1e-4),
                f"rgb_{m}_rows": close(pa[1], pb[1], rtol=1e-2, atol=1e-4)}
        return out

    kernel_phase(
        "fused_field", "nerf_emitter_tpu/ops/fused_field.py:391",
        "nerf_emitter_tpu_torch/csrc/fused_field.cu",
        lambda: ff._launch_field(pos2, dirs2, emb, bws, bbs, hws, hbs, **k2),
        lambda: ff._plain_field(pos2, dirs2, emb, bws, bbs, hws, hbs, **k2),
        k2_checks, 2.0 * m2 * (mlp_macs(bws) + mlp_macs(hws)), m2 * 40.0, reps=3,
        design=design("fused_field", "field_kernel", kernels.fused_field_occupancy(), kernels.field_smem_bytes(),
                      rows=m2),
    )
    del pos2, dirs2

    # K3 on the main path's rays, and on the first 1003 of them (a
    # part-filled last group); the f-major first-layer rows the query uses
    k3 = dict(s0=s0, s1=s1, s2=s2, freqs0=4, freqs1=6, **cfg)
    w0p, w1p = ff.permute_first(ws0, 4), ff.permute_first(ws1, 6)
    props = (w0p, bs0, w1p, bs1)
    k3_flops = 2.0 * n * (s0 * mlp_macs(ws0) + s1 * mlp_macs(ws1))

    def k3_checks(a, b):
        odd = [first(t) for t in (o_t, d_t, near_t, far_t)]
        with torch.no_grad():
            a_odd, b_odd = mq.proposal_bins(*odd, *props, **k3), mq._plain_proposal(*odd, *props, **k3)
        # spacing bins in [0, 1]: density roundoff moves the CDF by ~1e-4
        return {"sbins": close(a, b, rtol=0.0, atol=2e-3),
                f"sbins_{ODD_RAYS}_rays": close(a_odd, b_odd, rtol=0.0, atol=2e-3)}

    kernel_phase(
        "proposal", "nerf_emitter_tpu/ops/mega_query.py:711",
        "nerf_emitter_tpu_torch/csrc/proposal.cu",
        lambda: mq.proposal_bins(o_t, d_t, near_t, far_t, *props, **k3),
        lambda: mq._plain_proposal(o_t, d_t, near_t, far_t, *props, **k3),
        k3_checks, k3_flops, n * (8 + s2 + 1) * 4.0, reps=3,
        design=design("proposal", "proposal_kernelILi0E", kernels.proposal_occupancy(s0, s1, s2),
                      kernels.proposal_smem_bytes(s0, s1, s2), rays=n),
    )

    # K4 on the bins K3 gives these rays
    bwp = ff.permute_first(bws, 10)
    field = (bwp, bbs, hws, hbs)
    k4 = dict(s2=s2, freqs=10, hdr=True, rgb_bias=0.0, **cfg)
    k4_flops = 2.0 * n * s2 * (mlp_macs(bws) + mlp_macs(hws))
    with torch.no_grad():
        sbins = mq.proposal_bins(o_t, d_t, near_t, far_t, *props, **k3)
        sbins4 = mq.proposal_bins(*rows4, *props, **k3)

    def ulp_shift(bins, rows, out):
        """Largest relative move of the kernel's answer when every spacing
        bin moves up by one ulp: how well posed the comparison is."""
        up = torch.nextafter(bins, torch.full_like(bins, 2.0))
        moved = mq.field_composite(up, *rows, emb, *field, **k4)
        return float(((moved - out).abs() / out.abs().clamp(min=1e-3)).max())

    def k4_checks(a, b):
        with torch.no_grad():
            a4 = mq.field_composite(sbins4, *rows4, emb, *field, **k4)
            b4 = mq._plain_field_composite(sbins4, *rows4, emb, *field, **k4)
            odd = [first(t) for t in (sbins4, *rows4)]
            a_odd = mq.field_composite(*odd, emb, *field, **k4)
            b_odd = mq._plain_field_composite(*odd, emb, *field, **k4)
            rows = (o_t, d_t, near_t, far_t)
            fg_a, acc_a = split(*mq.field_composite(sbins, *rows, emb, *field, **k4, with_aux=True))
            fg_b, acc_b = split(*mq._plain_field_composite(sbins, *rows, emb, *field, **k4, with_aux=True))
            return {"rgb_far1e3": close(a, b, rtol=1e-1, atol=1e-3)
                    | {"one_ulp_bin_shift_rel": ulp_shift(sbins, rows, a)},
                    "foreground_far1e3": close(fg_a, fg_b, rtol=1e-2, atol=1e-3),
                    "acc_far1e3": close(acc_a, acc_b, rtol=1e-2, atol=1e-3),
                    "rgb_far4": close(a4, b4, rtol=1e-2, atol=1e-3)
                    | {"one_ulp_bin_shift_rel": ulp_shift(sbins4, rows4, a4)},
                    f"rgb_far4_{ODD_RAYS}_rays": close(a_odd, b_odd, rtol=1e-2, atol=1e-3)}

    kernel_phase(
        "field_composite", "nerf_emitter_tpu/ops/mega_query.py:731",
        "nerf_emitter_tpu_torch/csrc/field_composite.cu",
        lambda: mq.field_composite(sbins, o_t, d_t, near_t, far_t, emb, *field, **k4),
        lambda: mq._plain_field_composite(sbins, o_t, d_t, near_t, far_t, emb, *field, **k4),
        k4_checks, k4_flops, n * (s2 + 1 + 8 + 3) * 4.0, reps=3,
        design=design("field_composite", "field_composite_kernel", kernels.field_composite_occupancy(s2),
                      kernels.field_composite_smem_bytes(s2)),
    )

    # K5 on the main path's rays. Against K4 on K3's bins at the JAX
    # suite's bar for the pipelined kernel against the two-kernel path
    # (atol 1e-6, tests/test_fields.py:337), at far = 1e3 and far = 4;
    # against its chained twin at the query's bar (rtol 3e-2, atol 1e-3) at
    # far = 4, and at far = 1e3 through the aux split (1%). The chained twin's own bins
    # differ from K3's by hundreds of ulps (the line reports the gap), and
    # one ulp of the background sample's bins moves the answer by ~35% (K4
    # line), so the whole answer against the chained twin is reported, with
    # two held checks that locate its disagreement in the background colour
    # rgb_last: every value outside the 10% bar has its foreground and
    # accumulation within 1%, and with rgb_last taken from K5 on both sides
    # the whole answer is within 10%. At far = 1e3 the whole answer is also
    # held within 10% to the field twin on K3's bins, as K4 is.
    k5 = dict(k3, freqs=10, hdr=True, rgb_bias=0.0)
    rows = (o_t, d_t, near_t, far_t)
    with torch.no_grad():
        k34 = mq.field_composite(sbins, *rows, emb, *field, **k4)
        k34_4 = mq.field_composite(sbins4, *rows4, emb, *field, **k4)
        gap = (mq._plain_proposal(*rows, *props, **k3) - sbins).abs()
        last_ulp = torch.nextafter(sbins[-2:], torch.full_like(sbins[-2:], 2.0)) - sbins[-2:]
        bins_gap = dict(max_abs=float(gap.max()), rays_bitwise=int((gap == 0).all(dim=0).sum()),
                        rays=n, last_two_bins_max_ulps=float((gap[-2:] / last_ulp).max()))
        del gap, last_ulp

    def same(a, b):
        return close(a, b, rtol=0.0, atol=1e-6) | {"bitwise": bool(torch.equal(a, b))}

    def background_only(a, b, fg_a, fg_b, acc_a, acc_b, aux_a, aux_b):
        """Whether every value of a outside b's 10% bar has its foreground
        and its ray's accumulation within 1%: its disagreement is then in
        rgb_last (1 - acc). Reports how far rgb_last and (1 - acc) go."""
        outside = (a - b).abs() > 1e-3 + 1e-1 * b.abs()
        fg_ok = (fg_a - fg_b).abs() <= 1e-3 + 1e-2 * fg_b.abs()
        acc_ok = ((acc_a - acc_b).abs() <= 1e-3 + 1e-2 * acc_b.abs())[None].expand_as(a)
        explained = outside & fg_ok & acc_ok
        last_rel = ((aux_a[1:] - aux_b[1:]).abs() / aux_b[1:].abs().clamp(min=1e-3))[outside]
        one_minus_acc = (1.0 - acc_b).expand_as(a)[outside]
        fg_err = (fg_a - fg_b).abs()[outside]
        span = (lambda t: [float(t.min()), float(t.max())] if t.numel() else None)
        return dict(outside=int(outside.sum()), outside_explained=int(explained.sum()),
                    max_abs_err=float(fg_err.max()) if fg_err.numel() else 0.0,
                    outside_rgb_last_rel_range=span(last_rel),
                    outside_one_minus_acc_range=span(one_minus_acc),
                    within=bool(torch.equal(explained, outside)))

    def k5_checks(a, b):
        with torch.no_grad():
            a4 = mq.mega_pipeline(*rows4, emb, *props, *field, **k5)
            b4 = mq._plain_mega_pipeline(*rows4, emb, *props, *field, **k5)
            aux_a = mq.mega_pipeline(*rows, emb, *props, *field, **k5, with_aux=True)[1]
            aux_b = mq._plain_mega_pipeline(*rows, emb, *props, *field, **k5, with_aux=True)[1]
            odd = mq.mega_pipeline(*[first(t) for t in rows4], emb, *props, *field, **k5)
            on_k3_bins = mq._plain_field_composite(sbins, *rows, emb, *field, **k4)
        (fg_a, acc_a), (fg_b, acc_b) = split(a, aux_a), split(b, aux_b)
        return {"vs_k3_k4_far1e3": same(a, k34), "vs_k3_k4_far4": same(a4, k34_4),
                f"vs_k3_k4_far4_{ODD_RAYS}_rays": same(odd, first(k34_4)),
                "twin_far4": close(a4, b4, rtol=3e-2, atol=1e-3),
                "twin_foreground_far1e3": close(fg_a, fg_b, rtol=1e-2, atol=1e-3),
                "twin_acc_far1e3": close(acc_a, acc_b, rtol=1e-2, atol=1e-3),
                "field_twin_on_k3_bins_rgb_far1e3": close(a, on_k3_bins, rtol=1e-1, atol=1e-3),
                "twin_rgb_far1e3": close(a, b, rtol=1e-1, atol=1e-3) | {"held": False, "bins_gap": bins_gap},
                "twin_rgb_far1e3_outside_bar_is_background":
                    background_only(a, b, fg_a, fg_b, acc_a, acc_b, aux_a, aux_b),
                "twin_rgb_far1e3_shared_rgb_last":
                    close(a, fg_b + aux_a[1:] * (1.0 - acc_b), rtol=1e-1, atol=1e-3)}

    kernel_phase(
        "mega_pipeline", "nerf_emitter_tpu/ops/mega_query.py:677",
        "nerf_emitter_tpu_torch/csrc/mega_pipeline.cu",
        lambda: mq.mega_pipeline(*rows, emb, *props, *field, **k5),
        lambda: mq._plain_mega_pipeline(*rows, emb, *props, *field, **k5),
        k5_checks, k3_flops + k4_flops, n * (8 + 3) * 4.0, reps=3,
        design=design("mega_pipeline", "mega_pipeline_kernel", kernels.mega_pipeline_occupancy(s0, s1, s2),
                      kernels.mega_pipeline_smem_bytes(s0, s1, s2), rays=n),
    )
    del k34_4

    # The vjp kernel (the query's backward for a frozen NeRF) on K3's bins
    # of the main path's rays, given a random gradient at the answer,
    # against its plain version (autograd through K4's twin on the same
    # bins), at far = 1e3, at far = 4 and at far = 4 on the first 1003 rays
    # (a part-filled group). Each of the four gradients is held by its
    # relative L2 error and cosine: a flipped bf16 rounding moves a sample's
    # gradient by up to its top octave's weight, so an elementwise bar
    # cannot hold (reported). The first 1003 rays asked alone get their
    # rows of the whole answer bit for bit (no sum across rays).
    g_vjp = torch.randn((3, n), generator=g, device=dev)

    def vjp_close(a, b):
        out = {name: vectors_close(x, y, rel_l2=0.03, cos=0.999)
                     | {"max_abs_err": float((x - y).abs().max()),
                        "max_rel_err": float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))}
               for name, x, y in zip(("o", "d", "near", "far"), a, b)}
        return dict(out, within=all(c["within"] for c in out.values()),
                    max_abs_err=max(c["max_abs_err"] for c in out.values()))

    def vjp_checks(a, b):
        with torch.no_grad():
            a4 = mq.field_composite_vjp(sbins4, *rows4, g_vjp, emb, *field, **k4)
            b4 = mq._plain_field_composite_vjp(sbins4, *rows4, g_vjp, emb, *field, **k4)
            odd = [first(t) for t in (sbins4, *rows4, g_vjp)]
            a_odd = mq.field_composite_vjp(*odd, emb, *field, **k4)
            b_odd = mq._plain_field_composite_vjp(*odd, emb, *field, **k4)
        alone = [bool(torch.equal(first(x), y)) for x, y in zip(a4, a_odd)]
        return {"far1e3": vjp_close(a, b), "far4": vjp_close(a4, b4), f"far4_{ODD_RAYS}_rays": vjp_close(a_odd, b_odd),
                f"far4_{ODD_RAYS}_rays_alone_bitwise": dict(equal=alone, within=all(alone), max_abs_err=max(
                    float((first(x) - y).abs().max()) for x, y in zip(a4, a_odd)))}

    vjp_words = kernels.field_mask_words([w.shape for w in bws], [w.shape for w in hws])
    kernel_phase(
        "field_composite_vjp", "none: the JAX query's backward is jax.vjp through XLA "
        "(nerf_emitter_tpu/ops/mega_query.py:746-755)",
        "nerf_emitter_tpu_torch/csrc/field_composite_vjp.cu",
        lambda: mq.field_composite_vjp(sbins, o_t, d_t, near_t, far_t, g_vjp, emb, *field, **k4),
        lambda: mq._plain_field_composite_vjp(sbins, o_t, d_t, near_t, far_t, g_vjp, emb, *field, **k4),
        vjp_checks, 2.0 * k4_flops, n * (s2 + 1 + 8 + 3 + 8) * 4.0, reps=3,
        design=design("field_composite_vjp", "field_composite_vjp_kernel",
                      kernels.field_composite_vjp_occupancy(s2, vjp_words),
                      kernels.field_composite_vjp_smem_bytes(s2, vjp_words), rays=n),
    )
    del sbins4, g_vjp

    # ---- the wgmma field MLP of K4 and K5 alone (csrc/field_mlp.cu), on
    # the encodings of random scene points and the SH of random directions:
    # held against its twin (a bf16-operand, f32-accumulate chain) after its
    # first layer and after the whole MLP, first on 8191 rows, then at the
    # field's shape (2^16 x 48 rows), where each depth is timed (the launch
    # alone, on packed weights, writing nothing): the differences give each
    # layer's time. Beside it
    # the same layers as bf16 torch.matmul calls (bias and ReLU included),
    # a yardstick the port never calls. After the whole MLP the bar (K2's)
    # is held on what the field makes of the raw outputs, as K2's is: the
    # HDR colour exp(raw) and the density exp(raw - 1) (each raw value's
    # error is then a relative one); the raw outputs themselves, where f32
    # sums in another order leave ~1e-3 on values near 0, are reported.
    def mlp_rows(m):
        x2 = torch.rand((3, m), generator=g, device=dev) * 2.0 - 1.0
        dirs = torch.randn((3, m), generator=g, device=dev)
        sh = ff._sh4_rows(dirs / dirs.norm(dim=0, keepdim=True)).T.contiguous()
        return ff._freq_rows_fmajor(x2, 10).T.contiguous(), sh

    n_layers = len(bws) + len(hws)
    mlp_w = (bwp, bbs, hws, hbs)

    def mlp_checks(x, sh, tag):
        def at(dep):
            return (mq.field_mlp(x, sh, emb, *mlp_w, depth=dep),
                    mq._plain_field_mlp(x, sh, emb, *mlp_w, depth=dep))
        (a1, b1), (ab, bb), (a, b) = at(1), at(len(bws)), at(n_layers)
        return {f"first_layer_{tag}": close(a1, b1, rtol=1e-2, atol=1e-4),
                f"density_{tag}": close(torch.exp(ab[:, 0] - 1.0), torch.exp(bb[:, 0] - 1.0),
                                        rtol=1e-2, atol=1e-4),
                f"rgb_{tag}": close(torch.exp(a), torch.exp(b), rtol=1e-2, atol=1e-4),
                f"raw_out_{tag}": close(a, b, rtol=1e-2, atol=1e-4) | {"held": False}}

    with torch.no_grad():
        xs, shs = mlp_rows(8191)  # a part-filled last pass
        small = mlp_checks(xs, shs, "8191_rows")
        del xs, shs
    if not all(c["within"] for c in small.values() if c.get("held", True)):
        emit(dict(phase="field_mlp", checks=small))
        raise AssertionError(f"field_mlp: disagrees with its twin: {small}")
    xf, shf = mlp_rows(m2)
    kernels.reset_launches()
    with torch.no_grad():
        mq.field_mlp(xf, shf, emb, *mlp_w)
        torch.cuda.synchronize()
    mlp_launches = dict(kernels.launches)
    pack = kernels.FieldPack(*mlp_w, emb.shape[0], device=xf.device)
    xb = torch.zeros(m2, pack.k0, dtype=torch.bfloat16, device=dev)
    xb[:, : xf.shape[1]] = xf
    mlp_out = torch.empty(m2, 3, device=dev)
    depth_ms = [cuda_ms(lambda dep=dep: mq.launch_field_mlp(pack, xb, shf, emb, dep), 10)
                for dep in range(1, n_layers + 1)]
    steps = [depth_ms[0]] + [b - a for a, b in zip(depth_ms, depth_ms[1:])]
    nb = len(bws)
    layer_ms = {"base_first": steps[0], "base_hidden": steps[1:nb - 1], "base_out": steps[nb - 1],
                "head_hidden": steps[nb:n_layers - 1], "head_out_reduce": steps[n_layers - 1]}
    bf = torch.bfloat16
    chain = [(w.to(bf), b.to(bf)) for w, b in zip((*bwp, *hws), (*bbs, *hbs))]

    def gemm_chain():
        h = xf.to(bf)
        for i, (w, b) in enumerate(chain):
            h = torch.addmm(b, h, w)
            if i not in (nb - 1, n_layers - 1):
                h = torch.relu_(h)
            if i == nb - 1:
                h = torch.cat([shf.to(bf), h[:, 1:], emb.to(bf)[None].expand(m2, -1)], dim=1)
        return h

    gemm_chain_ms = cuda_ms(gemm_chain, 3)
    mlp_flops = 2.0 * m2 * (mlp_macs(bws) + mlp_macs(hws))
    kernel_phase(
        "field_mlp", "nerf_emitter_tpu/ops/fused_field.py:119",
        "nerf_emitter_tpu_torch/csrc/field_mlp.cu",
        lambda: mq.launch_field_mlp(pack, xb, shf, emb, n_layers, mlp_out),
        lambda: mq._plain_field_mlp(xf, shf, emb, *mlp_w),
        lambda a, b: mlp_checks(xf, shf, "full_rows") | small,
        mlp_flops, m2 * (64 * 2 + 16 * 4 + 3 * 4.0), reps=3,
        rows=m2, depth_ms=depth_ms, layer_ms=layer_ms, gemm_chain_ms=gemm_chain_ms,
        gemm_chain_tflops=mlp_flops / gemm_chain_ms * 1e-9,
        design=design("field_mlp", "field_mlp_kernel") | dict(smem_bytes=kernels.field_smem_bytes()),
    )
    del xf, shf, xb, pack, mlp_out, chain

    # ---- phase 3: the main path, 2^16 escaped rays through
    # make_nerf_emitter_fn, which builds the kernel query: K5
    emitter = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX)(camera_index=0)
    kernels.reset_launches()
    with torch.no_grad():
        t0 = time.perf_counter()
        rgb = emitter(x_unit, d)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    fwd_launches = dict(kernels.launches)
    if (fwd_launches.get("mega_pipeline", 0) < 1 or fwd_launches.get("proposal", 0)
            or fwd_launches.get("field_composite", 0)):
        raise AssertionError(f"the main path did not run K5 alone: {fwd_launches}")
    if rgb.shape != (n, 3) or not bool(torch.isfinite(rgb).all()):
        raise AssertionError("emitter output is not finite (n, 3)")

    # The same rays through K3, then K4 on K3's bins (the two-kernel form
    # of the query's answer).
    main_rays = ray_bundle(1e3)
    kernels.reset_launches()
    with torch.no_grad():
        rgb_two = k3_then_k4(model, main_rays)
        torch.cuda.synchronize()
    two_launches = dict(kernels.launches)
    if (two_launches.get("proposal", 0) < 1 or two_launches.get("field_composite", 0) < 1
            or two_launches.get("mega_pipeline", 0)):
        raise AssertionError(f"the two-kernel answer did not run K3 and K4 alone: {two_launches}")
    pipelined_vs_two = same(rgb, rgb_two)

    # the same rays through the model's plain forward on the card
    plain = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, use_fused=False)(camera_index=0)
    with torch.no_grad():
        ref = plain(x_unit[:nc], d[:nc])
    main_check = close(rgb[:nc], ref, rtol=3e-2, atol=1e-3)

    # K4 on the bins K3 gave these rays in phase 2 (held there against
    # both twins) reproduces the two-kernel answer bit for bit.
    # With it come each ray's accumulation and last-sample colour, which
    # split the answer against the model forward with a black background
    # (reported).
    with torch.no_grad():
        rgb_t, aux = mq.field_composite(sbins, *rows, emb, *field, **k4, with_aux=True)
        if not torch.equal(rgb_t.T, rgb_two):
            raise AssertionError("K4 on K3's bins does not reproduce the two-kernel answer")
        fg, acc = split(rgb_t[:, :nc], aux[:, :nc])
        black = copy.copy(model)
        black.background_color = "black"
        ref_fg = black(ray_bundle(1e3, nc), disable_aabb=torch.tensor(OBJECT_BOX, device=dev),
                       disable_aabb_on=True)
    fg_check = {"foreground": close(fg.T, ref_fg["rgb"], rtol=3e-2, atol=1e-3),
                "acc": close(acc, ref_fg["accumulation"][:, 0], rtol=3e-2, atol=1e-3)}
    del sbins, rgb_t, aux, k34
    with torch.no_grad():
        near_k = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0)(camera_index=0)(x_unit[:nc], d[:nc])
        near_p = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, use_fused=False)(
            camera_index=0)(x_unit[:nc], d[:nc])
    far4_check = close(near_k, near_p, rtol=3e-2, atol=1e-3)

    with torch.no_grad():
        ms = cuda_ms(lambda: emitter(x_unit, d), 5)
        ms_two = cuda_ms(lambda: k3_then_k4(model, main_rays), 5)
    # where each query's time goes: the device timeline of 3 calls
    trace = {"query": device_trace(lambda: emitter(x_unit, d)),
             "two_kernel_query": device_trace(lambda: k3_then_k4(model, main_rays))}
    emit(dict(phase="main_path", rays=n, samples=[s0, s1, s2], ms_per_query=ms,
              rays_per_s=n / (ms * 1e-3), ms_per_query_two_kernel=ms_two,
              rays_per_s_two_kernel=n / (ms_two * 1e-3), first_call_s=first_s, launches=fwd_launches,
              launches_two_kernel=two_launches, pipelined_vs_two_kernel=pipelined_vs_two,
              vs_model_far1e3=main_check, vs_model_far1e3_split=fg_check, vs_model_far4=far4_check,
              rgb_mean=float(rgb.mean()), peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
              trace=trace))
    if not far4_check["within"]:
        raise AssertionError(f"kernel query disagrees with the model forward: {far4_check}")
    if not pipelined_vs_two["within"]:
        raise AssertionError(f"K5 query disagrees with the two-kernel answer: {pipelined_vs_two}")
    del rgb, rgb_two, main_rays

    # ---- the staged query (K1 at both proposal levels, then K2 on the
    # field's samples), an entry point of its own: the main path's rays,
    # timed; held against the model's plain forward at far = 4 at the
    # query's bar, reported at far = 1e3 (see above)
    staged = ff.make_fused_radiance_query(model, disable_box=OBJECT_BOX, device=dev)
    full_rays = ray_bundle(1e3)
    kernels.reset_launches()
    with torch.no_grad():
        rgb_staged = staged(model, full_rays, camera_index=0)
        torch.cuda.synchronize()
    staged_launches = dict(kernels.launches)
    if (staged_launches.get("fused_density", 0) != 2 or staged_launches.get("fused_field", 0) != 1
            or len(staged_launches) != 2):
        raise AssertionError(f"the staged query did not run K1 twice and K2 once: {staged_launches}")
    if rgb_staged.shape != (n, 3) or not bool(torch.isfinite(rgb_staged).all()):
        raise AssertionError("staged query output is not finite (n, 3)")
    with torch.no_grad():
        staged_ms = cuda_ms(lambda: staged(model, full_rays, camera_index=0), 3)
        staged_far4 = close(staged(model, ray_bundle(4.0, nc), camera_index=0), near_p, rtol=3e-2, atol=1e-3)
    emit(dict(phase="staged_query", rays=n, ms_per_query=staged_ms, rays_per_s=n / (staged_ms * 1e-3),
              launches=staged_launches, vs_model_far4=staged_far4,
              vs_model_far1e3=close(rgb_staged[:nc], ref, rtol=3e-2, atol=1e-3) | {"held": False}))
    if not staged_far4["within"]:
        raise AssertionError(f"staged query disagrees with the model forward: {staged_far4}")
    del rgb_staged, full_rays

    # ---- phase 4: backward through the emitter w.r.t. the ray origins at
    # 2^14 rays, the NeRF's parameters trained: K5 forward, then the
    # staged recompute (K1 at both levels, the field through its twin, no
    # K2). Timed forward alone and forward plus backward; a device trace of
    # one forward plus backward splits it into K5, K1 and the rest (the twin
    # recompute, sampling and autograd's PyTorch ops); peak memory of one
    # forward plus backward. Then with the NeRF frozen (the vjp route).
    nb = BACKWARD_RAYS

    def fwd_bwd():
        x = x_unit[:nb].clone().requires_grad_()
        with torch.enable_grad():
            emitter(x, d[:nb]).sum().backward()
        return x.grad

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    grad = fwd_bwd()
    torch.cuda.synchronize()
    bwd_launches = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    grad_ok = bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0
    if bwd_launches.get("fused_density", 0) != 2 or bwd_launches.get("fused_field", 0):
        raise AssertionError(f"the backward did not run K1 twice and no K2: {bwd_launches}")
    if not grad_ok:
        raise AssertionError("non-finite or zero gradients")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: emitter(x_unit[:nb], d[:nb]), 3)
    fwd_bwd_ms = cuda_ms(fwd_bwd, 3)
    bwd_trace = device_trace(fwd_bwd, calls=1, top=10**6)
    ranked = sorted(bwd_trace["device_ms_by_name"].items(), key=lambda kv: -kv[1])
    k5_dev, k1_dev = (sum(v for k, v in ranked if name in k) for name in ("mega_pipeline_kernel", "density_kernel"))
    bwd_trace["device_ms_by_name"] = dict(ranked[:8]) | {"other": sum(v for _, v in ranked[8:])}

    # The same gradient at far = 4 held against the gradient through the
    # model's plain forward on the same rays. The random full-width field
    # varies on a ~0.006-unit scale (top octave 2^9), so its per-sample
    # gradients change across the ~1e-4 of the spacing range by which two
    # samplers place the bins (K1 against the model's densities); an
    # elementwise bar cannot hold. Held: the relative L2 error and the
    # cosine of the two gradients (the CPU measures 0.18 and 0.98 between
    # the same two paths at this width); elementwise reported.
    def x_grad(fn):
        x = x_unit[:nb].clone().requires_grad_()
        with torch.enable_grad():
            fn(x, d[:nb]).sum().backward()
        return x.grad

    g_kernel = x_grad(make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0)(camera_index=0))
    g_plain = x_grad(make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, use_fused=False)(camera_index=0))
    grad_far4 = vectors_close(g_kernel, g_plain, rel_l2=0.35, cos=0.9) | {
        "elementwise": close(g_kernel, g_plain, rtol=1e-1, atol=1e-3) | {"held": False}}
    del g_kernel, g_plain
    emit(dict(phase="backward", rays=nb, launches=bwd_launches, grad_finite=grad_ok,
              grad_abs_mean=float(grad.abs().mean()), forward_ms=fwd_ms, forward_backward_ms=fwd_bwd_ms,
              peak_mem_gb=peak_gb, grad_vs_model_far4=grad_far4,
              device_split_ms=dict(k5_forward=k5_dev, k1_staged_recompute=k1_dev,
                                   twin_recompute_and_other=bwd_trace["device_busy_ms"] - k5_dev - k1_dev),
              trace=bwd_trace))
    if not grad_far4["within"]:
        raise AssertionError(f"the query's gradient disagrees with the model forward's: {grad_far4}")

    # The same backward with the NeRF frozen (detach_nerf, as the takeover's
    # emitter): the vjp route, K3 and the vjp kernel after K5's forward and
    # nothing else; timed forward plus backward, its peak memory, its
    # gradient at far = 4 held against the model forward's at the same bars
    frozen = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, detach_nerf=True)(camera_index=0)

    def fwd_bwd_frozen():
        x = x_unit[:nb].clone().requires_grad_()
        with torch.enable_grad():
            frozen(x, d[:nb]).sum().backward()
        return x.grad

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    grad_frozen = fwd_bwd_frozen()
    torch.cuda.synchronize()
    frozen_launches = dict(kernels.launches)
    frozen_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    if frozen_launches != {"mega_pipeline": 1, "proposal": 1, "field_composite_vjp": 1}:
        raise AssertionError(f"the frozen backward did not run K5, K3 and the vjp once each: {frozen_launches}")
    frozen_ms = cuda_ms(fwd_bwd_frozen, 3)
    g_frozen = x_grad(make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, detach_nerf=True)(camera_index=0))
    g_plain = x_grad(make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, use_fused=False)(camera_index=0))
    frozen_far4 = vectors_close(g_frozen, g_plain, rel_l2=0.35, cos=0.9)
    emit(dict(phase="backward_frozen", rays=nb, launches=frozen_launches, forward_backward_ms=frozen_ms,
              peak_mem_gb=frozen_peak_gb, grad_finite=bool(torch.isfinite(grad_frozen).all()),
              grad_vs_model_far4=frozen_far4))
    if not frozen_far4["within"] or not torch.isfinite(grad_frozen).all():
        raise AssertionError(f"the frozen query's gradient disagrees with the model forward's: {frozen_far4}")
    del emitter, plain, staged, grad, frozen, grad_frozen, g_frozen, g_plain
    torch.cuda.empty_cache()

    # ---- phase 5: the profiling kernels against their twins. K3's bins
    # (P1's kernel A, P2's modes) are held at K3's bar on the main path's
    # rays, the shapes the profiling scripts use too. On the scripts' own
    # rays (from the origin, far 6, no carve-out) the comparison is
    # reported with the number of rays over the bar: there a few rays have
    # a level-1 sample midpoint on the scene-box face, where a rounding
    # difference in the level-0 densities flips the sample's keep mask and
    # moves the ray's CDF by a whole sample's weight; the modes without
    # resampled positions agree to ~1e-7 there. P1's kernel B runs on the
    # script's random bins, P3 on the resample script's weights.
    setup = ProfileSetup(dev, seed=args.seed)
    pn = setup.rows[0].shape[1]
    p_k4_flops = 2.0 * pn * s2 * (mlp_macs(setup.field[0]) + mlp_macs(setup.field[2]))

    def at_script_rays(kernel, twin):
        with torch.no_grad():
            a, b = kernel(*setup.rows, *setup.props, **setup.k3), twin(*setup.rows, *setup.props, **setup.k3)
        return close(a, b, rtol=0.0, atol=2e-3) | {
            "held": False, "rays_over_bar": int(((a - b).abs() > 2e-3).any(dim=0).sum()), "rays": pn}

    for name, replaces, kernel, twin in [
        ("profile_query.kernel_a", "scripts/profile_query.py:117", mq.proposal_bins, mq._plain_proposal),
    ] + [(f"proposal_variant[{m}]", "scripts/profile_kernel_a.py:148",
          functools.partial(mq.proposal_variant, mode=m), functools.partial(mq._plain_proposal, mode=m))
         for m in mq.PROPOSAL_MODES]:
        kernel_phase(
            name, replaces, "nerf_emitter_tpu_torch/csrc/proposal.cu",
            lambda k=kernel: k(*rows, *props, **k3), lambda t=twin: t(*rows, *props, **k3),
            lambda a, b, k=kernel, t=twin: {"sbins": close(a, b, rtol=0.0, atol=2e-3),
                                            "sbins_script_rays": at_script_rays(k, t)},
            0.0 if name.endswith("[resample-only]") else k3_flops, n * (8 + s2 + 1) * 4.0, reps=3,
        )
    kernel_phase(
        "profile_query.kernel_b", "scripts/profile_query.py:153",
        "nerf_emitter_tpu_torch/csrc/field_composite.cu",
        lambda: profile_query.kernel_b(setup),
        lambda: mq._plain_field_composite(setup.random_bins, *setup.rows, setup.emb, *setup.field,
                                          **setup.k4),
        # random bins at far 6 are well conditioned: K4's far = 4 bar
        lambda a, b: {"rgb": close(a, b, rtol=1e-2, atol=1e-3)},
        p_k4_flops, pn * (s2 + 1 + 8 + 3) * 4.0, reps=3,
    )
    rs_in = profile_resample.inputs(dev, seed=args.seed)
    r0, r1, r2 = profile_resample.S0, profile_resample.S1, profile_resample.S2
    rn = rs_in[0].shape[1]
    with torch.no_grad():
        # the ramp's f32 cancellation is ~1e-4 of the spacing range
        walk_vs_ramp = close(rs.resample(*rs_in, n_out=r2, form="walk"),
                             rs.resample(*rs_in, n_out=r2, form="ramp"), rtol=0.0, atol=2e-3)
    for form in rs.FORMS:
        kernel_phase(
            f"resample[{form}]", "scripts/profile_resample.py:167",
            "nerf_emitter_tpu_torch/csrc/resample.cu",
            lambda f=form: rs.resample(*rs_in, n_out=r2, form=f),
            lambda f=form: rs._plain_resample(*rs_in, n_out=r2, form=f),
            # f32 sums in other orders, each within ~1e-4 of exact
            lambda a, b: {"vs_twin": close(a, b, rtol=0.0, atol=2e-4), "walk_vs_ramp": walk_vs_ramp},
            # bound: the function's bytes, for both forms; the ramp's 4 f32
            # operations per (output, segment) cell are its algorithm's cost
            0.0, rn * 4.0 * (r0 + r0 + 1 + r1 + r2 + 1), reps=3,
            **({"ramp_cell_f32_ops": 4.0 * rn * ((r1 + 1) * (r0 + 1) + (r2 + 1) * (r1 + 1))}
               if form == "ramp" else {}),
        )

    # ---- phase 6: the three profiling entry points, each a path of its own
    script_launches = {}
    for name, mod, inputs in (("profile_query", profile_query, setup),
                              ("profile_kernel_a", profile_kernel_a, setup),
                              ("profile_resample", profile_resample, rs_in)):
        kernels.reset_launches()
        res = mod.run(inputs)
        torch.cuda.synchronize()
        script_launches[name] = dict(kernels.launches)
        emit(dict(phase=name, **res, launches=script_launches[name], lines=mod.report(res).splitlines()))

    # ---- phase 7: K5 at the schedules the takeover also runs, through the
    # emitter's samples_override: the gated reduced schedule of
    # sdf-nerfacto (128, 48, 24) and one override, (64, 32, 16). At far = 4
    # each is held against its chained twin at the query's bar and, bit
    # for bit, against K3 + K4; the emitter against the model forward at the
    # same schedule; each query timed at 2^16 rays.
    sched_launches, schedules = {}, {}
    for tag, (q0, q1, q2) in (("gated_reduced", (128, 48, 24)), ("override", (64, 32, 16))):
        kq3 = dict(k3, s0=q0, s1=q1, s2=q2)
        with torch.no_grad():
            kernels.reset_launches()
            fn = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, samples_override=(q0, q1, q2))(
                camera_index=0)
            got = fn(x_unit, d)
            torch.cuda.synchronize()
            sched_launches[tag] = dict(kernels.launches)
            ref_q = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, samples_override=(q0, q1, q2),
                                         use_fused=False)(camera_index=0)(x_unit[:nc], d[:nc])
            a = mq.mega_pipeline(*rows4, emb, *props, *field, **dict(kq3, freqs=10, hdr=True, rgb_bias=0.0))
            b = mq._plain_mega_pipeline(*rows4, emb, *props, *field,
                                        **dict(kq3, freqs=10, hdr=True, rgb_bias=0.0))
            c = mq.field_composite(mq.proposal_bins(*rows4, *props, **kq3), *rows4, emb, *field,
                                   **dict(k4, s2=q2))
            q_ms = cuda_ms(lambda: fn(x_unit, d), 5)
        if sched_launches[tag].get("mega_pipeline", 0) != 1 or len(sched_launches[tag]) != 1:
            raise AssertionError(f"{tag}: the emitter did not run K5 alone: {sched_launches[tag]}")
        schedules[tag] = dict(samples=[q0, q1, q2], ms_per_query=q_ms, rays_per_s=n / (q_ms * 1e-3),
                              twin_far4=close(a, b, rtol=3e-2, atol=1e-3), vs_k3_k4_far4=same(a, c),
                              emitter_vs_model_far4=close(got[:nc], ref_q, rtol=3e-2, atol=1e-3))
        del a, b, c, got
    emit(dict(phase="schedules", rays=n, launches=sched_launches, **schedules))
    bad = {t: k for t, s in schedules.items() for k, c in s.items() if isinstance(c, dict) and not c["within"]}
    if bad:
        raise AssertionError(f"K5 disagrees at another schedule: {bad}")
    sched_launches = {"mega_pipeline": sum(v.get("mega_pipeline", 0) for v in sched_launches.values())}

    # ---- phase 8: the `hash` model at nerfacto's published widths through
    # K7 (csrc/hash_grid.cu). Each launcher, the model's step and its point
    # lights against the plain twin (`hash_grid_phase`); the model's
    # pretraining (`pretrain` on the hash grids: the step of the benchmark's
    # `sdf-nerfacto-hashgrid.pretrain`, K7's forward and table gradient);
    # the trained field as the emitter at far = 4: its query, served by the
    # model forward (K7's forward alone, none of K1-K6), and the query's
    # backward with the NeRF frozen, as the takeover takes it (the
    # positions' gradient), held against the plain twin
    from nerf_emitter_tpu_torch.fields import encodings, nerfacto_field

    hg_rec = hash_grid_phase(dev, args.seed + 3)
    emit(hg_rec)
    k7_modes = {"hash_grid_forward": "forward", "hash_grid_forward[jvp]": "tangent",
                "hash_grid_backward": "table_grad", "hash_grid_positions_backward": "positions_grad"}
    for name, mode in k7_modes.items():  # ms: the three grids' launches at 2^16 rays' samples
        results[name] = dict(
            name=name, route="cuda", source="nerf_emitter_tpu_torch/csrc/hash_grid.cu",
            replaces="none: the JAX grid is plain XLA gathers (nerf_emitter_tpu/fields/encodings.py hash_encode)",
            max_abs_err=max(c[mode]["max_abs_err"] for c in hg_rec["checks"].values()),
            **{k: sum(grid[k][mode] for grid in hg_rec["grids"].values()) for k in ("ms", "plain_ms", "bound_ms")},
            bound_by="bytes", library_ms=None)
    t_phase = time.perf_counter()
    hmodel, htrain_rec, htrain_checks = pretrain(dev, args.seed + 5, implementation="hash")
    hash_train_launches = htrain_rec["launches_during_training"]
    emit(htrain_rec | dict(phase_s=time.perf_counter() - t_phase, checks=htrain_checks))
    if not all(htrain_checks.values()):
        raise AssertionError(f"hash pretraining: failed checks {htrain_checks}")
    h_emitter_of = functools.partial(make_nerf_emitter_fn, hmodel, 1.0, OBJECT_BOX, far=4.0)
    h_emitter = h_emitter_of()(camera_index=0)
    kernels.reset_launches()
    with torch.no_grad():
        h_rgb = h_emitter(x_unit, d)
        torch.cuda.synchronize()
        hash_launches = dict(kernels.launches)
        h_emitter_ms = cuda_ms(lambda: h_emitter(x_unit, d), 3)
        h_trace = device_trace(lambda: h_emitter(x_unit[:nc], d[:nc]), calls=1, top=10**6)
    ours = [k for k in h_trace["device_ms_by_name"] if any(e in k for e in KERNEL_ENTRIES)]
    h_frozen = h_emitter_of(detach_nerf=True)(camera_index=0)
    mb = BACKWARD_RAYS
    w_rgb = torch.rand((mb, 3), generator=torch.Generator(device=dev).manual_seed(args.seed + 9), device=dev)

    def h_emitter_grad():
        x = x_unit[:mb].clone().requires_grad_(True)
        (h_frozen(x, d[:mb]) * w_rgb).sum().backward()
        return x.grad

    kernels.reset_launches()
    gx_k = h_emitter_grad()
    torch.cuda.synchronize()
    hash_bwd_launches = dict(kernels.launches)
    h_bwd_ms = cuda_ms(h_emitter_grad, 3)
    real_grid, nerfacto_field.hash_grid = nerfacto_field.hash_grid, encodings.hash_encode
    try:
        gx_p = h_emitter_grad()
    finally:
        nerfacto_field.hash_grid = real_grid
    h_bwd_check = vectors_close(gx_k, gx_p, rel_l2=1e-4, cos=0.9999)
    emit(dict(phase="hash_field", rays=n, emitter_ms=h_emitter_ms, emitter_rays_per_s=n / (h_emitter_ms * 1e-3),
              launches=hash_launches, port_kernels_in_trace=ours, trace_device_events=h_trace["device_events"],
              table_rows=int(hmodel.field.hash_table.shape[0]), rgb_mean=float(h_rgb.mean()),
              backward_rays=mb, backward_ms=h_bwd_ms, backward_launches=hash_bwd_launches,
              backward_x_grad_vs_twin=h_bwd_check))
    if ours or set(hash_launches) != {"hash_grid_forward"}:
        raise AssertionError(f"the hash emitter ran another kernel than K7's forward: {hash_launches} {ours}")
    if set(hash_bwd_launches) != {"hash_grid_forward", "hash_grid_positions_backward"}:
        raise AssertionError(f"the hash emitter's frozen backward ran other launchers: {hash_bwd_launches}")
    if h_rgb.shape != (n, 3) or not bool(torch.isfinite(h_rgb).all()):
        raise AssertionError("hash emitter output is not finite (n, 3)")
    if not h_bwd_check["within"]:
        raise AssertionError(f"the hash emitter's gradient by x disagrees with the twin's: {h_bwd_check}")
    del hmodel, h_emitter, h_frozen, h_rgb, gx_k, gx_p
    torch.cuda.empty_cache()

    # ---- phase 9: the turntable. The K5 emitter with four turntable
    # rotations at rot_id 1 against the plain emitter (K5) on the
    # hand-rotated rays (a 90-degree turn maps the object box onto itself),
    # at far = 4 and the query's bar; at rot_id 0 bit for bit the plain
    # emitter. The model forward with camera_rot_ids on 1,024 rays against
    # the same weights on the CPU.
    rot = Rotater.from_axis_angle(4, center=torch.zeros(3, device=dev))
    tt_of = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0, rotater=rot)
    plain4 = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, far=4.0)(camera_index=0)
    rid = torch.ones(n, dtype=torch.long, device=dev)
    kernels.reset_launches()
    with torch.no_grad():
        tt1 = tt_of(camera_index=0, rot_id=1)(x_unit, d)
        tt0 = tt_of(camera_index=0, rot_id=0)(x_unit, d)
        torch.cuda.synchronize()
        tt_launches = dict(kernels.launches)
        hand = plain4(coords.world_to_unit(rot.apply_points(rid, unit_to_world(x_unit, 1.0)), 1.0),
                      rot.apply_dirs(rid, d))
        p4 = plain4(x_unit, d)
    tt_checks = {"rot_id1_vs_hand_rotated": close(tt1, hand, rtol=3e-2, atol=1e-3),
                 "rot_id0_vs_plain": same(tt0, p4)}
    cpu_model = copy.deepcopy(model).to("cpu")
    cam_rot = torch.arange(128, device=dev) % 4
    m_cpu = 1024  # rays held against the CPU
    tt_rays = ray_bundle(4.0, m_cpu)
    tt_rays = tt_rays.replace(camera_indices=torch.arange(m_cpu, device=dev)[:, None] % 128)
    with torch.no_grad():
        f_gpu = model(tt_rays, rotater=rot, camera_rot_ids=cam_rot, rotation_radius=0.6)
        f_cpu = cpu_model(RayBundle(**{k: v.cpu() for k, v in vars(tt_rays).items() if v is not None}),
                          rotater=Rotater.from_axis_angle(4, center=torch.zeros(3)),
                          camera_rot_ids=cam_rot.cpu(), rotation_radius=0.6)
    tt_checks |= {f"forward_camera_rot_ids_{k}": close(f_gpu[k].cpu(), f_cpu[k], rtol=2e-2, atol=1e-4)
                  for k in f_cpu}
    emit(dict(phase="turntable", rays=n, launches=tt_launches, checks=tt_checks))
    if tt_launches.get("mega_pipeline", 0) != 2 or len(tt_launches) != 1:
        raise AssertionError(f"the turntable emitter did not run K5 alone: {tt_launches}")
    if not all(c["within"] for c in tt_checks.values()):
        raise AssertionError(f"turntable: {tt_checks}")
    del tt1, tt0, hand, p4, f_gpu, f_cpu, cpu_model

    # ---- phase 10: the guiding build. Light probes from a ring of
    # GUIDE_CAMERAS cameras of GUIDE_RES^2 pixels at 1/4 resolution (the
    # size is picked so that at least 32,768 probes lie above the mean
    # luminance, the reference's point budget), then the compensation, the
    # 64-lobe EM, and the whole VMFGuiding.build, each timed. The
    # brightness gradient (a jvp) held against a central difference of the
    # brightness on 4,096 rays at far = 4, with the samples' distances
    # along each ray held fixed (the jvp stops the gradient through the
    # resampling weights, as the reference does, so an unfrozen difference
    # also measures how the bins move); step 1e-4, relative L2 error and
    # cosine held at 0.5 and 0.9 (the bf16 MLPs make the brightness a
    # staircase at small steps; the CPU measures 0.30 and 0.955 at this
    # width).
    guide_cams = ring_cameras(GUIDE_CAMERAS, GUIDE_RES, dev)
    guiding = VMFGuiding(scene_scale=1.0)
    box_t = torch.tensor(OBJECT_BOX, device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    pc = extract_light_point_cloud(model, guide_cams, object_aabb=box_t, downscale=guiding.downscale)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    n_bright = int((pc["luminance"] > pc["luminance"].mean()).sum())
    pts, w = compensate_pc(pc["points"], pc["luminance"], guiding.max_points)
    gg = torch.Generator(device=dev).manual_seed(args.seed + 4)
    t0 = time.perf_counter()
    fit_spherical_gmm(gg, coords.world_to_unit(pts, 1.0), w, guiding.n_clusters)
    torch.cuda.synchronize()
    em_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vmf = guiding.build(gg, model, guide_cams, box_t)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    guide_launches = dict(kernels.launches)
    fd_rays = ray_bundle(4.0, CHECK_RAYS)
    with torch.no_grad():
        jv = model.point_lights(fd_rays, disable_aabb=box_t, disable_aabb_on=True)["brightness_grad"]
        fd = frozen_brightness_difference(model, fd_rays, box_t, 1e-4)
    fd_check = vectors_close(jv, fd, rel_l2=0.5, cos=0.9) | {"step": 1e-4, "rays": CHECK_RAYS}
    emit(dict(phase="guiding", cameras=GUIDE_CAMERAS, image=[GUIDE_RES, GUIDE_RES], downscale=guiding.downscale,
              probe_rays=int(pc["luminance"].shape[0]), above_mean=n_bright, kept=int((w > 0).sum()),
              probe_s=probe_s, em_s=em_s, build_s=build_s, launches=guide_launches,
              k=int(vmf.weights.shape[0]), weights=vmf.weights.tolist(), stds=vmf.stds.tolist(),
              brightness_grad_vs_frozen_difference=fd_check))
    if n_bright < guiding.max_points:
        raise AssertionError(f"only {n_bright} probes above the mean; need {guiding.max_points}")
    if not (bool(torch.isfinite(vmf.positions).all()) and abs(float(vmf.weights.sum()) - 1.0) < 1e-4
            and bool((vmf.stds > 0).all())):
        raise AssertionError("the guiding mixture is not finite and normalised")
    if not fd_check["within"]:
        raise AssertionError(f"brightness_grad disagrees with the difference: {fd_check}")
    del pc, pts, w, jv, fd

    # ---- phase 11: the distilled light-field cache at the default
    # DistillConfig (6x256 bf16 student, batch 2^14, 2,000 steps, 8
    # held-out batches), its teacher the K5 emitter (far = 1e3, as the
    # takeover serves it), half of its directions from phase 10's mixture.
    # Fails unless the loss is finite and fell (last 50 steps' mean below
    # the first 50's) and K5 ran once per step and held-out batch.
    cfg_d = DistillConfig()
    teacher = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, detach_nerf=True)
    gd = torch.Generator(device=dev).manual_seed(args.seed + 5)
    kernels.reset_launches()
    t0 = time.perf_counter()
    student, fidelity, losses = distill_emitter(gd, model, teacher, scene_scale=1.0, object_aabb=OBJECT_BOX,
                                                num_cameras=128, guiding=vmf, config=cfg_d)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    distill_launches = dict(kernels.launches)
    losses = losses.cpu()
    # where a step's time goes: the device timeline of a 5-step fit
    d_trace = device_trace(lambda: distill_emitter(
        gd, model, teacher, scene_scale=1.0, object_aabb=OBJECT_BOX, num_cameras=128, guiding=vmf,
        config=DistillConfig(steps=5, holdout_batches=1)), calls=1)
    k = min(50, len(losses) // 2)
    fell = float(losses[-k:].mean()) < float(losses[:k].mean())
    emit(dict(phase="distill", steps=cfg_d.steps, batch=cfg_d.batch, hidden=cfg_d.hidden, depth=cfg_d.depth,
              guided_frac=cfg_d.guided_frac, seconds=distill_s,
              ms_per_step=distill_s * 1e3 / (cfg_d.steps + cfg_d.holdout_batches),
              launches=distill_launches, loss_first=float(losses[0]), loss_last=float(losses[-1]),
              loss_first50_mean=float(losses[:k].mean()), loss_last50_mean=float(losses[-k:].mean()),
              fidelity=fidelity, trace_5_steps=d_trace))
    if not (bool(torch.isfinite(losses).all()) and fell):
        raise AssertionError(f"the distillation loss is not finite or did not fall: {losses[:3]} {losses[-3:]}")
    if distill_launches != {"mega_pipeline": cfg_d.steps + cfg_d.holdout_batches}:
        raise AssertionError(f"the teacher did not run K5 once per batch: {distill_launches}")

    # ---- phase 12: the distilled path, the student's emitter_fn_of, at
    # 2^16 of bench.py's emitter rays (x_unit uniform in [0.35, 0.65]^3, box
    # +-0.3, scene_scale 1), timed with CUDA events after a warm-up (mean of
    # 10) beside the K5 emitter on the same rays (mean of 5), with the
    # student's relative RMS error against the teacher there.
    s_fn = make_student_emitter_fn_of(student, scene_scale=1.0, object_aabb=OBJECT_BOX)(model, camera_index=0)
    t_fn = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX)(camera_index=0)
    kernels.reset_launches()
    with torch.no_grad():
        s_out = s_fn(x_unit, d)
        torch.cuda.synchronize()
        student_launches = dict(kernels.launches)
        t_out = t_fn(x_unit, d)
        s_ms = cuda_ms(lambda: s_fn(x_unit, d), 10)
        t_ms = cuda_ms(lambda: t_fn(x_unit, d), 5)
        s_trace = device_trace(lambda: s_fn(x_unit, d), top=8)
    rel = (s_out - t_out) / (t_out + 1e-2)
    emit(dict(phase="distilled_path", rays=n, ms_per_query=s_ms, rays_per_s=n / (s_ms * 1e-3),
              k5_ms_per_query=t_ms, k5_rays_per_s=n / (t_ms * 1e-3), speedup=t_ms / s_ms,
              relrms_linear_vs_teacher=float(torch.sqrt(torch.mean(rel**2))),
              rmse_log_vs_teacher=float(torch.sqrt(torch.mean(
                  (torch.log(s_out + 1e-3) - torch.log(t_out.clamp(min=0.0) + 1e-3)) ** 2))),
              launches=student_launches, trace=s_trace))
    if student_launches or s_out.shape != (n, 3) or not bool(torch.isfinite(s_out).all()):
        raise AssertionError(f"the student's answer is not finite (n, 3) from plain PyTorch: {student_launches}")
    del s_fn, t_fn, s_out, t_out
    torch.cuda.empty_cache()

    # ---- phase 12b: the SDF renderer (`render_check`): one view at 64^2,
    # spp 4, under an envmap on the card against the CPU from the same
    # draws, the march's CUDA graph against the eager march, then lit by
    # K5 against the model's plain forward at far = 4.
    t_phase = time.perf_counter()
    render_rec, render_checks, render_launches = render_check(dev, model, vmf, args.seed)
    emit(dict(phase="render", **render_rec, checks=render_checks, phase_s=time.perf_counter() - t_phase))
    bad = [k for k, c in render_checks.items() if not c["within"]]
    if bad:
        raise AssertionError(f"render: failed checks {bad}: {render_checks}")
    if render_launches.get("mega_pipeline", 0) < 1:
        raise AssertionError(f"the K5-lit render did not run K5: {render_launches}")

    # ---- phase 12c: the takeover (`takeover`) at sdf-nerfacto's width, lit
    # by the distilled student with the vMF mixture proposing: steps at
    # 64^2, 128^2 (through the 127^3 upsample) and 256^2 (253^3, 4 gradient
    # bands), then one K5-lit step held against the model forward's.
    t_phase = time.perf_counter()
    take_rec, take_checks, take_launches = takeover(dev, args.seed, model, student, vmf)
    emit(dict(phase="takeover", **take_rec, checks=take_checks, phase_s=time.perf_counter() - t_phase))
    bad = [k for k, c in take_checks.items() if not (c["within"] if isinstance(c, dict) else c)]
    if bad:
        raise AssertionError(f"takeover: failed checks {bad}: {take_checks}")
    if take_launches.get("mega_pipeline", 0) < 1 or take_launches.get("field_composite_vjp", 0) < 1:
        raise AssertionError(f"the K5-lit takeover step did not run K5 and the vjp: {take_launches}")
    del student
    torch.cuda.empty_cache()

    # ---- phase 12d: the JAX suite's shape recovery (`recovery`) on the card
    t_phase = time.perf_counter()
    rec_rec, rec_checks = recovery(dev, args.seed)
    emit(dict(phase="recovery", **rec_rec, checks=rec_checks, phase_s=time.perf_counter() - t_phase))
    if not all(rec_checks.values()):
        raise AssertionError(f"recovery: {rec_checks}")

    # ---- phase 13: NeRF pretraining (`pretrain`: sdf-nerfacto's model,
    # batch, losses and schedule, 100 steps; the step is plain PyTorch and
    # launches none of the port's kernels), then the trained field as the
    # emitter: the main path's 2^16 rays at far = 4 through K5 (the default
    # query) and through K3 + K4, K5 held against the model forward at the
    # main path's bar (rtol 3e-2, atol 1e-3) and bit for bit against K3 + K4.
    t_phase = time.perf_counter()
    tmodel, train_rec, train_checks = pretrain(dev, args.seed)
    trained_of = functools.partial(make_nerf_emitter_fn, tmodel, 1.0, OBJECT_BOX, far=4.0)
    t_k5_fn = trained_of()(camera_index=0)
    kernels.reset_launches()
    with torch.no_grad():
        t_k5 = t_k5_fn(x_unit, d)
        torch.cuda.synchronize()
    train_k5 = dict(kernels.launches)
    kernels.reset_launches()
    with torch.no_grad():
        t_two = k3_then_k4(tmodel, ray_bundle(4.0))
        torch.cuda.synchronize()
    train_two = dict(kernels.launches)
    with torch.no_grad():
        t_ref = trained_of(use_fused=False)(camera_index=0)(x_unit[:nc], d[:nc])
        t_ms = cuda_ms(lambda: t_k5_fn(x_unit, d), 3)
    train_checks |= {"k5_vs_model_far4": close(t_k5[:nc], t_ref, rtol=3e-2, atol=1e-3),
                     "k5_bitwise_k3_k4_far4": same(t_k5, t_two)}
    emitter_rec = dict(rays=n, far=4.0, ms_per_query=t_ms, rays_per_s=n / (t_ms * 1e-3),
                       rgb_mean=float(t_k5.mean()), launches=train_k5, launches_two_kernel=train_two)
    emit(train_rec | dict(phase_s=time.perf_counter() - t_phase, emitter=emitter_rec, checks=train_checks))
    if train_k5 != {"mega_pipeline": 1} or train_two != {"proposal": 1, "field_composite": 1}:
        raise AssertionError(f"the trained field's emitter did not run K5, then K3 + K4: {train_k5} {train_two}")
    # a dict check holds by its bit equality where it has one, else by its bar
    bad = [k for k, c in train_checks.items()
           if not (c.get("bitwise", c["within"]) if isinstance(c, dict) else c)]
    if bad:
        raise AssertionError(f"train: failed checks {bad}: {train_checks}")
    del tmodel, t_k5, t_two, t_ref, t_k5_fn
    torch.cuda.empty_cache()

    # ---- phase 13b: sdf-nerfacto through its train CLI (`pipeline`):
    # pretraining, the TSDF init, the guiding, the cache distilled with K5
    # as its teacher, takeover steps, an eval view lit by K5, checkpoints,
    # then --resume in a new Trainer
    t_phase = time.perf_counter()
    pipe_rec, pipe_checks, pipe_launches = pipeline(dev, args.seed)
    emit(dict(phase="pipeline", **pipe_rec, checks=pipe_checks, phase_s=time.perf_counter() - t_phase))
    bad = [k for k, c in pipe_checks.items() if not (c["within"] if isinstance(c, dict) else c)]
    if bad:
        raise AssertionError(f"pipeline: failed checks {bad}: {pipe_checks}")
    if pipe_launches.get("mega_pipeline", 0) < 1:
        raise AssertionError(f"the pipeline did not run K5: {pipe_launches}")
    torch.cuda.empty_cache()

    # ---- phase 13c: the end-task tools (`endtask`): gen_data, the
    # sdf-nerfacto run with the emitter pinned to K5 (K5 and, in the
    # takeover's backward, K3 and the vjp), eval (NVS and relit), every render
    # subcommand, the exporter and chamfer, held against the CPU and float64
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as end_root:
        end_rec, end_checks, end_launches = endtask(dev, args.seed, root=end_root)
        emit(dict(phase="endtask", **end_rec, checks=end_checks, phase_s=time.perf_counter() - t_phase))
        bad = [k for k, c in end_checks.items() if not c["within"]]
        if bad:
            raise AssertionError(f"endtask: failed checks {bad}: {end_checks}")
        if end_launches.get("mega_pipeline", 0) < 1 or end_launches.get("field_composite_vjp", 0) < 1:
            raise AssertionError(f"the end-task path did not run K5 and the vjp: {end_launches}")

        # ---- phase 13d: the learned denoiser (`denoise`) on the endtask
        # run's K5-lit renders: the fit through the render CLI and through
        # fit_scene_denoiser, a denoised view, apply timed, held against the
        # CPU; then the card tools (texture, convert_mesh_to_sdf,
        # forward_gradient) against the CPU
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        den_rec, den_checks, den_launches = denoise(dev, args.seed, Path(end_root))
        emit(dict(phase="denoise", **den_rec, checks=den_checks, phase_s=time.perf_counter() - t_phase))
    bad = [k for k, c in den_checks.items() if not c["within"]]
    if bad:
        raise AssertionError(f"denoise: failed checks {bad}: {den_checks}")
    if den_launches.get("mega_pipeline", 0) < 1:
        raise AssertionError(f"the denoising path did not run K5: {den_launches}")
    torch.cuda.empty_cache()

    # ---- phase 13e: the web viewer beside sdf-nerfacto's train CLI
    # (`viewer`): renders in every mode before and after the takeover,
    # renders beside the running steps, pause, resume and stop, the
    # stopped run's checkpoint rendering the last view again
    t_phase = time.perf_counter()
    view_rec, view_checks, view_launches = viewer(dev, args.seed)
    emit(dict(phase="viewer", **view_rec, checks=view_checks, phase_s=time.perf_counter() - t_phase))
    bad = [k for k, c in view_checks.items() if not c]
    if bad:
        raise AssertionError(f"viewer: failed checks {bad}: {view_checks}")
    torch.cuda.empty_cache()

    # ---- phase 13f: across ranks on the one card (`multi_gpu`): two gloo
    # ranks against one rank (the NeRF step, a K5-lit takeover step, the
    # emitter query), the train CLI in two processes, and a one-rank NCCL
    # world through the CLI
    t_phase = time.perf_counter()
    mg_rec, mg_checks, mg_launches = multi_gpu(dev, args.seed)
    emit(dict(phase="multi_gpu", **mg_rec, checks=mg_checks, launches=mg_launches,
              phase_s=time.perf_counter() - t_phase))
    bad = [k for k, c in mg_checks.items() if not c]
    if bad:
        raise AssertionError(f"multi_gpu: failed checks {bad}: {mg_checks}")

    # ---- phase 14: the kernels line. K5 carries the query (phase 3), the
    # other schedules (phase 7), the turntable (phase 9), the
    # distillation's teacher (phase 11), the trained field's emitter
    # (phase 13), the train CLI's run (phase 13b), the end-task tools
    # (phase 13c), the learned denoiser's renders (phase 13d), the viewer's
    # renders (phase 13e) and the ranks' takeover step and query (phase
    # 13f); K3 and K4 the two-kernel query (phases 3 and 13); K2 the
    # staged query; K1 the backward with the NeRF's parameters trained
    # (phase 4) and the staged query; K3 and the vjp kernel the backward
    # with the NeRF frozen (phase 4) and the K5-lit takeovers (phases 12c,
    # 13c and 13f); K7's forward the hash pretraining step, the hash
    # emitter's query and its backward, its tangent `point_lights`, its
    # table gradient the pretraining step, its positions' gradient the
    # emitter's backward (phase 8); the
    # field MLP alone its own phase (one launch at the field's shape); P1-P3
    # the profiling scripts (phase 6). Each reports its launches in the
    # runs of its own paths.
    # `launches` sums a kernel's paths; `launches_by_path` splits them.
    path_of = {"mega_pipeline": ["query", "schedules", "turntable", "distill", "render", "takeover", "train",
                                 "pipeline", "endtask", "denoise", "viewer", "multi_gpu"],
               "proposal": ["two_kernel_query", "train", "backward_frozen", "takeover", "endtask", "multi_gpu"],
               "field_mlp": ["field_mlp"], "field_composite": ["two_kernel_query", "train"],
               "fused_density": ["backward", "staged_query"],
               "field_composite_vjp": ["backward_frozen", "takeover", "endtask", "multi_gpu"],
               "fused_field": ["staged_query"], "profile_query.kernel_a": ["profile_query"],
               "profile_query.kernel_b": ["profile_query"]}
    path_of |= {"hash_grid_forward": ["hash_pretrain", "hash_field", "hash_emitter_backward"],
                "hash_grid_forward[jvp]": ["hash_point_lights"], "hash_grid_backward": ["hash_pretrain"],
                "hash_grid_positions_backward": ["hash_emitter_backward"]}
    path_of |= {f"proposal_variant[{m}]": ["profile_kernel_a"] for m in mq.PROPOSAL_MODES}
    path_of |= {f"resample[{f}]": ["profile_resample"] for f in rs.FORMS}
    counted_as = {"profile_query.kernel_a": "proposal", "profile_query.kernel_b": "field_composite"}
    counts = {"query": fwd_launches, "two_kernel_query": two_launches, "backward": bwd_launches,
              "backward_frozen": frozen_launches,
              "staged_query": staged_launches, "field_mlp": mlp_launches, "schedules": sched_launches,
              "turntable": tt_launches, "distill": distill_launches, "render": render_launches,
              "takeover": take_launches, "train": train_k5 | train_two, "pipeline": pipe_launches,
              "endtask": end_launches, "denoise": den_launches, "viewer": view_launches,
              "multi_gpu": mg_launches, "hash_pretrain": hash_train_launches, "hash_field": hash_launches,
              "hash_point_lights": hg_rec["point_lights_launches"], "hash_emitter_backward": hash_bwd_launches,
              **script_launches}

    def by_path(name):
        return {p: counts[p].get(counted_as.get(name, name), 0) for p in path_of[name]}

    line = {"kernels": [
        {k: results[name][k] for k in ("name", "route", "source", "replaces")}
        | {"launches": sum(by_path(name).values()), "launches_by_path": by_path(name)}
        | {k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
        for name in results
    ]}
    idle = [k["name"] for k in line["kernels"] if min(k["launches_by_path"].values()) < 1]
    if idle:
        raise AssertionError(f"kernels not launched on their paths: {idle}")
    emit(dict(phase="total", script_s=time.perf_counter() - t_script, card=card))
    print(card, flush=True)
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
