"""The port's tracing (nerf_emitter_tpu_torch/utils/profiler.py), on the
CPU: off by default, when a takeover period opens no span, leaves no
`nek::` range in a profiler trace and makes no counter; on, the takeover's
spans nest as named, its emitter and probe counters equal the benchmark
wrappers' counts of the same period, the kept answers equal a hand count
from render_direct's hit and visibility, and the kernel query's backward
counts its recompute chunks. The takeover is the benchmark's K5 cell at
its tiny size (benchmark/tiny.json), lit on the CPU by the model's own
forward: the frozen NeRF's chunked route, whose backward is the span
emitter.backward."""

import inspect
import json
import math
import sys
import threading
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark.drivers.port_trace import trace_window
from benchmark.drivers.takeover import Driver
from benchmark.tracing_cost import counts_pairs
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.guiding.light_pc import extract_light_point_cloud
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops import mega_query
from nerf_emitter_tpu_torch.renderer import integrator
from nerf_emitter_tpu_torch.renderer.emitters import VMFMixture
from nerf_emitter_tpu_torch.renderer.scene import SdfScene
from nerf_emitter_tpu_torch.renderer.sphere_trace import SphereTraceConfig
from nerf_emitter_tpu_torch.utils import profiler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL = "sdf-nerfacto-k5.takeover"


@pytest.fixture(autouse=True)
def tracing_off():
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


@pytest.fixture(scope="module")
def takeover():
    """The K5 takeover cell at its tiny size on the CPU, set up to step 70:
    each traced period (2 steps from 70) starts with a guiding rebuild."""
    tiny = json.loads((ROOT / "benchmark" / "tiny.json").read_text())[CELL]
    tiny["traffic"] = dict(tiny["traffic"], window_step=70)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    driver = Driver(bench_run.Run(CELL, 7, 0.0, True, torch.device("cpu"), bench, tiny))
    profiler.disable()
    driver.setup()
    return driver


def _ranges(prof) -> dict:
    """The `nek::` ranges of a profile: {span: [(start ns, end ns), ...]}."""
    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiler.PREFIX):
            out[e.name()[len(profiler.PREFIX):]].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_tracing_off_leaves_no_range_and_no_counter(takeover, monkeypatch):
    """Off (the library's default), a takeover period with its guiding
    rebuild opens no span and counts no tensor: the profile holds the
    period's operators and no `nek::` range, and nothing is recorded."""
    assert not profiler.enabled()

    def no_span(self, name):
        raise AssertionError(f"span {name} opened while tracing is off")

    real_count = profiler.count

    def count(name, n):
        assert not isinstance(n, torch.Tensor), f"{name} summed on the device while tracing is off"
        real_count(name, n)

    monkeypatch.setattr(profiler._Span, "__init__", no_span)
    monkeypatch.setattr(profiler, "count", count)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        takeover._period()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert any(n.startswith("aten::") for n in names)
    assert not _ranges(prof)
    assert profiler.counters() == {} and profiler.spans() == {}


# each span's parents: every range of the span lies inside a range of one of them
PARENTS = {
    "takeover.guiding": ("takeover.step",),
    "takeover.sdf_step": ("takeover.step",),
    "takeover.post_step_host": ("takeover.step",),
    "guiding.probes": ("takeover.guiding",),
    "guiding.fit": ("takeover.guiding",),
    "sdf.detached": ("takeover.sdf_step",),
    "sdf.band_forward": ("takeover.sdf_step",),
    "sdf.band_backward": ("takeover.sdf_step",),
    "sdf.apply": ("takeover.sdf_step",),
    "emitter.forward": ("sdf.detached", "sdf.band_forward", "sdf.band_backward"),
    "emitter.backward": ("sdf.band_backward",),
    "render.march": ("sdf.detached", "sdf.band_forward", "sdf.band_backward"),
}


def test_spans_nest_as_named(takeover):
    """On, a period of two steps (the first with a guiding rebuild) opens
    each takeover span inside its parent, the checkpoint's recompute asks
    the emitter again inside the band's backward, and the spans' calls
    and host seconds are kept."""
    profiler.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        takeover._period()
    profiler.disable()
    ranges = _ranges(prof)
    assert set(ranges) == set(PARENTS) | {"takeover.step"}
    for child, parents in PARENTS.items():
        for s, f in ranges[child]:
            assert any(a <= s and f <= b for p in parents for a, b in ranges[p]), child
    assert any(a <= s and f <= b for s, f in ranges["emitter.forward"] for a, b in ranges["sdf.band_backward"])
    got = profiler.spans()
    assert got["takeover.step"]["calls"] == 2 and got["takeover.guiding"]["calls"] == 1
    assert got["takeover.sdf_step"]["calls"] == 2 and got["sdf.apply"]["calls"] == 2
    assert all(s["host_s"] > 0 and s["device_s"] == 0 for s in got.values())
    assert {k: len(v) for k, v in ranges.items()} == {k: s["calls"] for k, s in got.items()}


def test_counters_match_the_benchmark_wrappers(takeover):
    """In the benchmark's traced period, the port's tracing on: emitter.rays
    is the wrappers' rays and grad_rays, emitter.grad_rays their grad_rays,
    emitter.rerun_rays their recompute_rays, guiding.probe_rays the probes'
    rays, and guiding.probe_calls the period's one rebuild's point_lights
    calls, ceil(probe rays / chunk); the kept answers are some and no more
    than the rays asked. The tracing is off again afterwards."""
    reading = trace_window(takeover, True)
    for name, (wrappers, port) in counts_pairs(reading).items():
        assert wrappers == port > 0, (name, wrappers, port)
    c = reading["program_counts"]
    assert 0 < c["emitter.used_rays"] <= c["emitter.rays"]
    chunk = inspect.signature(extract_light_point_cloud).parameters["chunk"].default
    assert c["guiding.probe_calls"] == math.ceil(c["guiding.probe_rays"] / chunk) > 0
    assert not profiler.enabled() and profiler.counters() == {}


def _pinhole_rays(n_side=12):
    """Rays from one point through an n_side^2 grid on the plane z = 0.5
    (the unit cube's render space), some past the sphere."""
    xs = torch.linspace(0.2, 0.8, n_side)
    gx, gy = torch.meshgrid(xs, xs, indexing="ij")
    tgt = torch.stack([gx, gy, torch.full_like(gx, 0.5)], -1).reshape(-1, 3)
    o = torch.tensor([0.5, 0.55, -0.45]).expand_as(tgt).contiguous()
    return o, torch.nn.functional.normalize(tgt - o, dim=-1)


@pytest.mark.parametrize("mis", ["both", "one_sample"])
def test_used_rays_is_the_hand_count(mis, monkeypatch):
    """emitter.used_rays equals the answers render_direct keeps, counted by
    hand from its `hit` and the visibility traces' answers (hit and visible
    for each surface term, escaped for the miss term), and never exceeds
    emitter.rays (every call's rows)."""
    g = torch.Generator().manual_seed(3)
    lobes = VMFMixture(positions=torch.rand((4, 3), generator=g), weights=torch.rand(4, generator=g) + 0.2,
                       stds=torch.rand(4, generator=g) * 0.5 + 0.1)
    scene = SdfScene.create(sdf_res=24, tex_res=4, init_radius=0.25).replace(guiding=lobes)
    o, d = _pinhole_rays()
    visibility = []
    real_trace = integrator.sphere_trace

    def sphere_trace(*args, **kwargs):
        out = real_trace(*args, **kwargs)
        visibility.append(~out[1])
        return out

    monkeypatch.setattr(integrator, "sphere_trace", sphere_trace)
    cfg = integrator.RenderConfig(mis_mode=mis, reparam="soft",
                                  trace=SphereTraceConfig(max_steps=48, hit_eps=1e-3))
    profiler.enable()
    out = integrator.render_direct(scene, o, d, g, emitter_fn=lambda x, dd: 1.0 + dd.abs(), config=cfg)
    profiler.disable()
    hit = out["hit"]
    assert len(visibility) == (1 if mis == "one_sample" else 2)
    want = sum(int((hit & v).sum()) for v in visibility) + int((~hit).sum())
    c = profiler.counters()
    assert c["emitter.rays"] == o.shape[0] * len(visibility)
    assert c["emitter.used_rays"] == want
    assert 0 < int(hit.sum()) < o.shape[0] and want < c["emitter.rays"]


def test_the_kernel_query_backward_counts_its_chunks(monkeypatch):
    """The kernel query's backward (K5's twin on the CPU) is the span
    emitter.backward; it counts its recompute chunks and their rows, the
    last chunk's padding included."""
    model = NerfactoModel(((-1.5,) * 3, (1.5,) * 3), num_nerf_samples=8, num_proposal_samples=(16, 8),
                          num_cameras=2, appearance_embedding_dim=8, implementation="freq", device="cpu")
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", 16)
    query = mega_query.make_mega_radiance_query(model, device="cpu")
    g = torch.Generator().manual_seed(0)
    n = 40
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1).requires_grad_()
    rays = RayBundle(origins=torch.rand((n, 3), generator=g) * 0.4 - 0.2, directions=d,
                     pixel_area=torch.full((n, 1), 1e-4), nears=torch.full((n, 1), 0.05),
                     fars=torch.full((n, 1), 3.0), camera_indices=torch.ones((n, 1), dtype=torch.long))
    profiler.enable()
    query(model, rays, camera_index=1).sum().backward()
    profiler.disable()
    assert d.grad is not None and torch.isfinite(d.grad).all()
    assert profiler.counters() == {"emitter.recompute_chunks": 3, "emitter.recompute_rays": 48}
    assert profiler.spans()["emitter.backward"]["calls"] == 1


def test_spans_and_counters_as_decorators_blocks_and_aliases(capsys):
    """A span as a decorator (switched at each call) and as a block, the
    reference's aliases, int and tensor counts, the summary of host and
    device ms on standard error, and reset."""

    @profiler.span("t.fn")
    def fn(x):
        return x + 1

    assert fn(1) == 2 and profiler.spans() == {}  # off: nothing kept
    profiler.enable()
    assert fn(1) == 2
    with profiler.span("t.block"), profiler.time_block("t.alias"):
        profiler.count("t.n", 3)
        profiler.count("t.n", torch.tensor(4))
    profiler.time_function(fn, name="t.wrapped")(2)
    profiler.disable()
    got = profiler.spans()
    assert {k: s["calls"] for k, s in got.items()} == {"t.fn": 2, "t.block": 1, "t.alias": 1, "t.wrapped": 1}
    assert profiler.counters() == {"t.n": 7}
    profiler._print_summary()
    out, err = capsys.readouterr()
    assert out == "" and "t.block: host" in err and "device" in err and "t.n: 7" in err
    profiler.reset()
    assert profiler.spans() == {} and profiler.counters() == {}


def test_counters_and_spans_lose_no_update_across_threads():
    """Spans and counters entered from many threads at once (a custom
    backward runs on autograd's thread) keep every call and every count."""
    threads, per = 16, 300
    profiler.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with profiler.span("t.thread"):
                    profiler.count("t.calls", 1)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
        profiler.disable()
    assert profiler.counters() == {"t.calls": threads * per}
    assert profiler.spans()["t.thread"]["calls"] == threads * per
