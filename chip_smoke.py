"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's kernels from nerf_emitter_tpu_torch/csrc with nvcc, holds
each kernel against its plain PyTorch twin at the shapes its path gives it
(and at part-filled sizes), runs the wgmma field MLP of K2, K4 and K5 alone
(held layer by layer, timed per layer kind beside a bf16 torch.matmul
chain), answers 2^16 escaped emitter rays at the full width of the
sdf-nerfacto `freq` model (random weights from --seed) through the default
kernel query (K5), through the two-kernel query (K3 + K4) and through the
staged query (K1 + K2), checks the answers against the model's plain
forward, times a backward pass through the query at 2^14 rays, and runs the
three profiling entry points at their own shapes. Every phase prints one
JSON line; any failure raises and the script exits non-zero. The last line
is {"ok": true, "device": {...}}.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import subprocess
import sys
import time

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
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
    from nerf_emitter_tpu_torch.ops import fused_field as ff
    from nerf_emitter_tpu_torch.ops import mega_query as mq
    from nerf_emitter_tpu_torch.ops import resample as rs
    from nerf_emitter_tpu_torch.ops.colliders import aabb_far_intersect_collider
    from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn
    from nerf_emitter_tpu_torch.scripts import profile_kernel_a, profile_query, profile_resample
    from nerf_emitter_tpu_torch.scripts.profiling import ProfileSetup, device_trace
    from nerf_emitter_tpu_torch.utils.coords import unit_to_world

    # the run measures the query's defaults
    for knob in ("NERF_EMITTER_MEGA_PIPELINED", "NERF_EMITTER_MEGA_MXU_CHUNK"):
        os.environ.pop(knob, None)
    # f32 comparisons on the card run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    # K1 at both proposal levels, as the backward runs it (one launch each):
    # 2^16 x 256 samples with F=4 and 2^16 x 96 samples with F=6; also on
    # the first 1003 x 256 and 1003 x 96 rows (the latter ends in a
    # part-filled pass) and 1003 rows (a part-filled warpgroup tile)
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
    # (atol 1e-6, tests/test_fields.py:337), at far = 1e3 and far = 4; with
    # mxu_chunk = 3 against mxu_chunk = 1 at the same bar; against its
    # chained twin at the query's bar (rtol 3e-2, atol 1e-3) at far = 4, and
    # at far = 1e3 through the aux split (1%). The chained twin's own bins
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
            chunk3 = mq.mega_pipeline(*rows, emb, *props, *field, **k5, mxu_chunk=3)
            odd = mq.mega_pipeline(*[first(t) for t in rows4], emb, *props, *field, **k5)
            on_k3_bins = mq._plain_field_composite(sbins, *rows, emb, *field, **k4)
        (fg_a, acc_a), (fg_b, acc_b) = split(a, aux_a), split(b, aux_b)
        return {"vs_k3_k4_far1e3": same(a, k34), "vs_k3_k4_far4": same(a4, k34_4),
                "mxu_chunk3_vs_1": same(chunk3, a),
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
    del sbins4, k34_4

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
    # make_nerf_emitter_fn, which builds the default query: K5
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

    # The same rays through the two-kernel query (K3 + K4), which the
    # NERF_EMITTER_MEGA_PIPELINED=0 switch selects when the query is built.
    os.environ["NERF_EMITTER_MEGA_PIPELINED"] = "0"
    try:
        two_emitter = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX)(camera_index=0)
    finally:
        del os.environ["NERF_EMITTER_MEGA_PIPELINED"]
    kernels.reset_launches()
    with torch.no_grad():
        rgb_two = two_emitter(x_unit, d)
        torch.cuda.synchronize()
    two_launches = dict(kernels.launches)
    if (two_launches.get("proposal", 0) < 1 or two_launches.get("field_composite", 0) < 1
            or two_launches.get("mega_pipeline", 0)):
        raise AssertionError(f"the two-kernel query did not run K3 and K4 alone: {two_launches}")
    pipelined_vs_two = same(rgb, rgb_two)

    # the same rays through the model's plain forward on the card
    plain = make_nerf_emitter_fn(model, 1.0, OBJECT_BOX, use_fused=False)(camera_index=0)
    with torch.no_grad():
        ref = plain(x_unit[:nc], d[:nc])
    main_check = close(rgb[:nc], ref, rtol=3e-2, atol=1e-3)

    # K4 on the bins K3 gave these rays in phase 2 (held there against
    # both twins) reproduces the two-kernel query's answer bit for bit.
    # With it come each ray's accumulation and last-sample colour, which
    # split the answer against the model forward with a black background
    # (reported).
    with torch.no_grad():
        rgb_t, aux = mq.field_composite(sbins, *rows, emb, *field, **k4, with_aux=True)
        if not torch.equal(rgb_t.T, rgb_two):
            raise AssertionError("K4 on K3's bins does not reproduce the two-kernel query's answer")
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
        ms_two = cuda_ms(lambda: two_emitter(x_unit, d), 5)
    # where each query's time goes: the device timeline of 3 calls
    trace = {"query": device_trace(lambda: emitter(x_unit, d)),
             "two_kernel_query": device_trace(lambda: two_emitter(x_unit, d))}
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
        raise AssertionError(f"K5 query disagrees with the two-kernel query: {pipelined_vs_two}")
    del rgb, rgb_two

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
    # 2^14 rays: K5 forward, then the staged recompute (K1 at both levels,
    # the field through its twin, no K2). Timed forward alone and forward
    # plus backward; a device trace of one forward plus backward splits it
    # into K5, K1 and the rest (the twin recompute, sampling and autograd's
    # PyTorch ops); peak memory of one forward plus backward.
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
    emit(dict(phase="backward", rays=nb, launches=bwd_launches, grad_finite=grad_ok,
              grad_abs_mean=float(grad.abs().mean()), forward_ms=fwd_ms, forward_backward_ms=fwd_bwd_ms,
              peak_mem_gb=peak_gb,
              device_split_ms=dict(k5_forward=k5_dev, k1_staged_recompute=k1_dev,
                                   twin_recompute_and_other=bwd_trace["device_busy_ms"] - k5_dev - k1_dev),
              trace=bwd_trace))
    del emitter, two_emitter, plain, staged, grad
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

    # ---- phase 7: the kernels line. K5 carries the query (phase 3), K3 and
    # K4 the two-kernel query (phase 3), K2 the staged query, K1 the
    # backward (phase 4) and the staged query,
    # the field MLP alone its own phase (one launch at the field's shape),
    # P1-P3 the profiling scripts (phase 6); each reports its launches in
    # the run of its own path.
    path_of = {"mega_pipeline": "query", "proposal": "two_kernel_query", "field_mlp": "field_mlp",
               "field_composite": "two_kernel_query", "fused_density": "backward",
               "fused_field": "staged_query", "profile_query.kernel_a": "profile_query",
               "profile_query.kernel_b": "profile_query"}
    path_of |= {f"proposal_variant[{m}]": "profile_kernel_a" for m in mq.PROPOSAL_MODES}
    path_of |= {f"resample[{f}]": "profile_resample" for f in rs.FORMS}
    counted_as = {"profile_query.kernel_a": "proposal", "profile_query.kernel_b": "field_composite"}
    counts = {"query": fwd_launches, "two_kernel_query": two_launches, "backward": bwd_launches,
              "staged_query": staged_launches,
              "field_mlp": mlp_launches, **script_launches}
    line = {"kernels": [
        {k: results[name][k] for k in ("name", "route", "source", "replaces")}
        | {"path": path_of[name], "launches": counts[path_of[name]].get(counted_as.get(name, name), 0)}
        | {k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")}
        for name in results
    ]}
    idle = [k["name"] for k in line["kernels"] if k["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels not launched on their paths: {idle}")
    print(card, flush=True)
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
