"""What the profiling entry points share: their configuration (the
reference scripts' 2^16 rays from the origin, near 0.05, far 6.0, no
carve-out, samples (256, 96, 48), 128 cameras, the `freq` model with random
weights from a seed), a timer, a device-timeline trace, and `Stages`, which
times the calls of a run's stages.

On CUDA a time is the mean of `iters` calls between two CUDA events, after
one warm-up call. On the CPU, which a caller asks for explicitly (the
tests do, at a tiny size), it is the host clock around the same calls.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..cameras.rays import RayBundle
from ..models.nerfacto import NerfactoModel
from ..ops.fused_field import _mlp_params, named_params, permute_first
from ..utils.device import resolve_device

NUM_RAYS = 2**16
N_ITERS = 8
AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
SAMPLES = (256, 96)
NERF_SAMPLES = 48


def timer(device: torch.device, iters: int):
    """timed(fn) -> mean ms per call of fn() over `iters` calls, after a
    warm-up call."""

    def timed(fn) -> float:
        with torch.no_grad():
            fn()
            if device.type != "cuda":
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                return (time.perf_counter() - t0) / iters * 1e3
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters

    return timed


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_trace(fn, calls: int = 3, top: int = 6) -> dict:
    """Traces `calls` back-to-back calls of fn() (after a warm-up call) with
    torch.profiler and splits the window from the first host op to the last
    device activity: device busy time (the union of kernels, copies and
    sets), its idle share, device time per kernel name (the `top` largest,
    the rest summed as "other"), and the `top` longest idle gaps with the
    device activity that ends each. All times in ms per window."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.no_grad():
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    host = [e for e in events if e.get("cat") == "cpu_op"]
    dev = sorted((e for e in events if e.get("cat") in _DEVICE_CATS), key=lambda e: e["ts"])
    start = min(e["ts"] for e in host + dev)
    end = max(e["ts"] + e["dur"] for e in host + dev)
    busy, gaps, reach, per_name = 0.0, [], start, {}
    for e in dev:
        e_end = e["ts"] + e["dur"]
        if e["ts"] > reach:
            gaps.append((e["ts"] - reach, e["name"]))
        busy += max(0.0, e_end - max(e["ts"], reach))
        reach = max(reach, e_end)
        name = e["name"].split("(")[0].split("<")[0]
        per_name[name] = per_name.get(name, 0.0) + e["dur"]
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])
    kernels = {k: v / 1e3 for k, v in ranked[:top]}
    if len(ranked) > top:
        kernels["other"] = sum(v for _, v in ranked[top:]) / 1e3
    window = (end - start) / 1e3
    return dict(calls=calls, window_ms=window, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / 1e3 / window if window > 0 else None,
                device_events=len(dev), device_ms_by_name=kernels,
                gaps_ms=[dict(ms=g / 1e3, before=n.split("(")[0][:60])
                         for g, n in sorted(gaps, reverse=True)[:top]])


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class ProfileSetup:
    """The reference scripts' model and rays on one device, and the
    kernels' inputs made from them: rays as (3, N) / (1, N) rows, the
    proposal and field weights with f-major first-layer rows, camera 0's
    appearance vector, and the keyword arguments of K3 and K4."""

    def __init__(self, device=None, num_rays: int = NUM_RAYS, seed: int = 0,
                 samples=SAMPLES, nerf_samples: int = NERF_SAMPLES):
        self.device = dev = resolve_device(device)
        torch.manual_seed(seed)
        self.model = NerfactoModel(AABB, num_nerf_samples=nerf_samples, num_proposal_samples=samples,
                                   num_cameras=128, implementation="freq", device=dev)
        g = torch.Generator(device="cpu").manual_seed(seed)
        d = torch.randn((num_rays, 3), generator=g)
        d = (d / d.norm(dim=-1, keepdim=True)).to(dev)
        self.rays = RayBundle(
            origins=torch.zeros((num_rays, 3), device=dev), directions=d,
            pixel_area=torch.full((num_rays, 1), 1e-4, device=dev),
            nears=torch.full((num_rays, 1), 0.05, device=dev),
            fars=torch.full((num_rays, 1), 6.0, device=dev),
            camera_indices=torch.zeros((num_rays, 1), dtype=torch.long, device=dev),
        )
        self.rows = tuple(t.T.contiguous() for t in (self.rays.origins, self.rays.directions,
                                                    self.rays.nears, self.rays.fars))
        p = named_params(self.model)
        ws0, bs0 = _mlp_params(p, "proposal_0.mlp")
        ws1, bs1 = _mlp_params(p, "proposal_1.mlp")
        self.props = (permute_first(ws0, 4), bs0, permute_first(ws1, 6), bs1)
        bws, bbs = _mlp_params(p, "field.base_mlp")
        hws, hbs = _mlp_params(p, "field.head_mlp")
        self.field = (permute_first(bws, 10), bbs, hws, hbs)
        self.emb = p["field.appearance_embedding.weight"][0].detach().contiguous()
        box = dict(aabb_lo=AABB[0], aabb_inv_ext=(1.0 / 3.0,) * 3, disable_box=None, avg_density=1.0)
        s0, s1 = samples
        self.k3 = dict(s0=s0, s1=s1, s2=nerf_samples, freqs0=4, freqs1=6, **box)
        self.k4 = dict(s2=nerf_samples, freqs=10, hdr=self.model.hdr, rgb_bias=self.model.rgb_bias,
                       **box)
        # B alone runs on plausible bins: sorted uniforms in [0, 1)
        u = torch.rand((nerf_samples + 1, num_rays), generator=g)
        self.random_bins = torch.sort(u, dim=0).values.to(dev).contiguous()


class Stages:
    """While entered, wraps methods and module functions: for each call its
    seconds (host clock with the device synchronised before and after; with
    `events`, CUDA events around the call and nothing synchronised), the
    port's kernel launches during it, and optionally what it returned
    (`keep_out`), its arguments (`keep_args`) and after(args[0])
    (`after`, for a method: of its object once the call returned). The
    wrappers only observe; leaving restores the originals."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.calls: dict[str, list] = {}
        self._undo = []

    def wrap(self, owner, attr: str, *, stage=None, events=False, keep_out=False, keep_args=False, after=None):
        from .. import kernels

        real = getattr(owner, attr)
        calls = self.calls.setdefault(stage or attr, [])
        cuda = self.cuda

        @functools.wraps(real)
        def timed(*args, **kwargs):
            before = dict(kernels.launches)
            if events and cuda:
                marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                marks[0].record()
                out = real(*args, **kwargs)
                marks[1].record()
                rec = {"events": marks}
            else:
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*args, **kwargs)
                if cuda:
                    torch.cuda.synchronize()
                rec = {"s": time.perf_counter() - t0}
            rec["launches"] = {k: n - before.get(k, 0) for k, n in kernels.launches.items() if n != before.get(k, 0)}
            if keep_out:
                rec["out"] = out
            if keep_args:
                rec["args"] = (args, kwargs)
            if after is not None:
                rec["after"] = after(args[0])
            calls.append(rec)
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, real))

    def seconds(self, stage: str) -> list:
        """Each call's seconds (CUDA events read after a synchronise)."""
        if self.cuda:
            torch.cuda.synchronize()
        return [c["events"][0].elapsed_time(c["events"][1]) * 1e-3 if "events" in c else c["s"]
                for c in self.calls.get(stage, [])]

    def __enter__(self) -> "Stages":
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()
