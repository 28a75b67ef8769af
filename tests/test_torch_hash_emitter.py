"""The frozen hash-grid NeRF as the takeover's emitter, on the CPU: the port's
emitter closure (`pipelines/nerf_emitter.make_nerf_emitter_fn`, its
chunked route `_ChunkedQuery`) against the benchmark's
plain reference (`benchmark/reference/pipeline.make_emitter_fn_of`) on the
same seeded weights.

The model is the benchmark's `sdf-nerfacto-hashgrid-emitter` configuration
at its tiny size (`benchmark/tiny/<cell>.json`: a 2^12-row table a level,
finest resolution 64, schedule (16, 8, 8)). RECOMPUTE_RAYS is set to 16, so
that a call of an odd number of rays crosses several chunks and its last
chunk is padded."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark import program
from benchmark import run as bench_run
from benchmark.drivers.common import ref_model, weight_shapes
from benchmark.reference.cameras.rays import RayBundle as RefRayBundle
from benchmark.reference.ops.colliders import aabb_far_intersect_collider
from benchmark.reference.pipeline import make_emitter_fn_of
from benchmark.reference.utils import coords as ref_coords
from benchmark.reference.utils.device import id_column
from nerf_emitter_tpu_torch.ops import mega_query
from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn
from nerf_emitter_tpu_torch.utils import profiler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL = "sdf-nerfacto-hashgrid-emitter.takeover"
CHUNK = 16
N = 101  # 7 chunks of 16, the last 5 rows and 11 of padding
CAMERA = 1
# The port's closure and the reference run the same plain modules on the
# CPU (the reference is a frozen copy of them; the port's hash grid takes
# its plain twin, `hash_encode`), so every difference comes from the shapes
# the two are asked in: the port in chunks of 16 rays (the last padded),
# the reference in one chunk of 101. A matrix product's rows then round
# alike and the answers are equal bit for bit (measured: 0 for the
# radiance and both gradients); the bars leave room for a BLAS that blocks
# its rows by the product's height.
RTOL = 1e-5


@pytest.fixture(autouse=True)
def tracing_off():
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


@pytest.fixture(scope="module")
def cell():
    """The cell's configuration at its tiny size, its seeded weights, the
    port's model and the reference's model from them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sizes = json.loads((ROOT / "benchmark" / "tiny" / f"{CELL}.json").read_text())
    run = bench_run.Run(CELL, 3000000019, 0.0, False, torch.device("cpu"), bench, sizes)
    cfg, views = run.config, sizes["traffic"]["views"]
    assert cfg["model"]["implementation"] == "hash" and cfg["model"]["log2_hashmap_size"] == 12
    weights = run.make_weights(weight_shapes(cfg, views))
    model = program.build_model(cfg, views, weights, torch.device("cpu"))
    ref = ref_model(cfg, views, weights, torch.device("cpu"), "bf16")
    p = cfg["pipeline"]
    box = tuple(map(tuple, p["object_aabb"]))
    return {"model": model, "ref": ref, "scale": p["scene_scale"], "box": box}


def _rays(n=N, seed=4):
    """n rays from points in and around the object box (world [-0.8, 0.8]^3),
    directions on the sphere."""
    g = torch.Generator().manual_seed(seed)
    x = 0.5 + (torch.rand((n, 3), generator=g) - 0.5) * 0.8
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return x, d


def _answer(fn, x, d, weights):
    """fn's radiance at (x, d) and the gradients of x and d of <weights,
    radiance>."""
    x, d = x.clone().requires_grad_(), d.clone().requires_grad_()
    out = fn(x, d)
    gx, gd = torch.autograd.grad((out * weights).sum(), (x, d))
    return out.detach(), gx, gd


def _port(cell, **kw):
    return make_nerf_emitter_fn(cell["model"], cell["scale"], cell["box"], detach_nerf=True, **kw)(
        camera_index=CAMERA)


def _plain(cell, x, d, far=1e3):
    """The reference's model asked in one call, autograd keeping its graph
    and its parameters trained: the rays as `make_emitter_fn_of` makes
    them."""
    box = torch.tensor(cell["box"])
    o = ref_coords.unit_to_world(x, cell["scale"])
    n = o.shape[0]
    rays = RefRayBundle(origins=o, directions=d, pixel_area=torch.full((n, 1), 1e-4), nears=torch.zeros((n, 1)),
                        fars=torch.full((n, 1), far), camera_indices=id_column(CAMERA, (n, 1), o.device))
    rays = aabb_far_intersect_collider(rays, box, far=far)
    return cell["ref"](rays, train=False, hdr_radiance_only=True, disable_aabb=box, disable_aabb_on=True)["rgb"]


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


def test_the_chunked_route_matches_the_reference(cell, monkeypatch):
    """Radiance and the gradients of the ray's origin and direction, the
    port's chunked route against the reference's plain query; no NeRF
    parameter gets a gradient."""
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", CHUNK)
    x, d = _rays()
    w = torch.rand((N, 3), generator=torch.Generator().manual_seed(7))
    got = _answer(_port(cell), x, d, w)
    want = _answer(make_emitter_fn_of(cell["ref"], cell["scale"], cell["box"])(camera_index=CAMERA), x, d, w)
    for name, a, b in zip(("radiance", "grad x", "grad d"), got, want):
        assert torch.isfinite(a).all() and b.abs().max() > 0, name
        assert _rel(a, b) <= RTOL, (name, _rel(a, b))
    assert all(p.grad is None for p in cell["model"].parameters())


@pytest.mark.parametrize("chunk", [1 << 16, CHUNK], ids=["one_chunk", "chunks"])
def test_the_trained_route_matches_the_reference(cell, monkeypatch, chunk):
    """With the NeRF's parameters trained, the chunked route's gradient of
    each parameter against that of the reference's model asked in one
    call, by name; the proposal networks get none in either (the resample
    stops the gradient at their weights, so the final samples' edges are
    constants for the parameters too). In one chunk the two are equal bit
    for bit (measured: 0 on every parameter). In chunks of 16 the MLPs'
    weight gradient is a bf16 product rounded once a chunk, then summed in
    f32, so it departs by up to one bf16 rounding, 2^-8 (measured: 1.4e-3
    to 2.1e-3); the tables' and the embedding's, summed in f32, stay under
    RTOL (measured: 1e-7)."""
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", chunk)
    x, d = _rays()
    w = torch.rand((N, 3), generator=torch.Generator().manual_seed(9))
    grads = []
    for model, fn in ((cell["model"], make_nerf_emitter_fn(cell["model"], cell["scale"], cell["box"])(
                           camera_index=CAMERA)),
                      (cell["ref"], lambda x, d: _plain(cell, x, d))):
        named = dict(model.named_parameters())
        out = fn(x, d)
        got = torch.autograd.grad((out * w).sum(), list(named.values()), allow_unused=True)
        grads.append({k: g for k, g in zip(named, got)})
    port, ref = grads
    assert port.keys() == ref.keys()
    trained = [k for k, g in ref.items() if g is not None and g.abs().max() > 0]
    assert trained and all("proposal" not in k for k in trained)
    for k in port:
        if k in trained:
            bar = 2.0 ** -8 if chunk == CHUNK and "_mlp." in k else RTOL
            assert _rel(port[k], ref[k]) <= bar, (k, _rel(port[k], ref[k]))
        else:
            assert port[k] is None or not port[k].any(), k


def test_chunks_answer_as_one_chunk(cell, monkeypatch):
    """The answer and the gradients in chunks of 16 rays equal those of the
    same call in one chunk."""
    x, d = _rays()
    w = torch.rand((N, 3), generator=torch.Generator().manual_seed(8))
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", 1 << 16)
    whole = _answer(_port(cell), x, d, w)
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", CHUNK)
    chunked = _answer(_port(cell), x, d, w)
    for name, a, b in zip(("radiance", "grad x", "grad d"), chunked, whole):
        assert _rel(a, b) <= RTOL, (name, _rel(a, b))


def test_the_counters_are_the_hand_count(cell, monkeypatch):
    """One call and its backward, traced: the forward's chunks, the
    recompute's chunks and its rows (the last chunk's padding included),
    and one emitter.backward span."""
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", CHUNK)
    x, d = _rays()
    profiler.enable()
    _answer(_port(cell), x, d, torch.ones((N, 3)))
    profiler.disable()
    chunks = math.ceil(N / CHUNK)
    c = profiler.counters()
    assert {k: v for k, v in c.items() if k.startswith("emitter.")} == {
        "emitter.forward_chunks": chunks, "emitter.recompute_chunks": chunks, "emitter.recompute_rays": chunks * CHUNK}
    assert profiler.spans()["emitter.backward"]["calls"] == 1


def test_the_forward_keeps_the_rays_and_the_edges_alone(cell, monkeypatch):
    """Under saved_tensors_hooks, the chunked route's forward saves, beside
    the parameters it was given, its rays and the final samples' spacing
    edges, (num_nerf_samples + 1) values a ray, and no tensor larger, with
    the NeRF frozen and with it trained; the model's forward in one call
    saves its whole graph."""
    monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", CHUNK)
    x, d = _rays()
    params = {t.data_ptr() for t in cell["model"].parameters()} | {t.data_ptr() for t in cell["ref"].parameters()}

    def saved(fn):
        sizes = []

        def pack(t):
            if t.data_ptr() not in params:
                sizes.append(t.numel())
            return t

        xg, dg = x.clone().requires_grad_(), d.clone().requires_grad_()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(xg, dg)
        return sizes

    edges = cell["model"].num_nerf_samples + 1
    trained = make_nerf_emitter_fn(cell["model"], cell["scale"], cell["box"])(camera_index=CAMERA)
    for route in (_port(cell), trained):
        kept = saved(route)
        assert kept and max(kept) == edges * N and sum(kept) <= (edges + 6) * N, kept
    plain = saved(lambda x, d: _plain(cell, x, d))
    assert sum(plain) > 100 * sum(kept)
