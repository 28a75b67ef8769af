"""The hash grid as the fields encode with it (`ops/hash_grid.hash_grid`, K7's
autograd Function), on the CPU, held against autograd through the plain
`fields/encodings.hash_encode`, which the Function's CPU twins run: the forward, the table's and the
positions' gradients, `torch.func.jvp`, two training steps of a tiny hash
model against the benchmark's reference model, and the port's spans and
counters. The kernel itself (csrc/hash_grid.cu) runs on the card only:
`chip_smoke.hash_grid_phase` holds it against the same twins there.

A seeded grid of 6 levels over a 2^10 table: two dense levels (5^3 and
7^3 rows) and four hashed ones; points uniform in [-0.1, 1.1]^3 (outside
the clamp on some axes), on the box's faces 0 and 1, and on grid
vertices."""

import json
from pathlib import Path

import pytest
import torch

from nerf_emitter_tpu_torch import kernels
from nerf_emitter_tpu_torch.fields.encodings import HashGridSpec, hash_encode
from nerf_emitter_tpu_torch.ops import hash_grid as hg
from nerf_emitter_tpu_torch.utils import profiler

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# On the CPU the Function's twins are autograd and torch.func.jvp through
# `hash_encode` itself, so its gradients and its tangent by the positions
# equal those of the plain function bit for bit. A tangent in both the
# table and the positions is the sum of two parts the Function computes
# apart (the features are linear in the table), where forward mode through
# `hash_encode` adds each corner's two terms first: the same terms in
# another order, which differ by f32 round-off alone (measured 7e-8 by the
# relative L2 norm of the difference).
GRAD_RTOL = 1e-6


def _spec():
    spec = HashGridSpec(num_levels=6, features_per_level=2, log2_hashmap_size=10, min_res=4, max_res=64)
    assert [row[3] for row in spec.level_rows] == [1, 1, 0, 0, 0, 0]
    return spec


def _inputs(n=400, seed=0):
    g = torch.Generator().manual_seed(seed)
    spec = _spec()
    table = spec.init_table(scale=1.0).uniform_(-1.0, 1.0, generator=g)
    pos = torch.rand((n, 3), generator=g) * 1.2 - 0.1
    pos[:20, 0] = 0.0
    pos[20:40, 1] = 1.0
    pos[40:50] = 1.0
    pos[50:60] = 0.0
    pos[60:70] = 0.5  # a vertex of every level whose resolution is even
    return spec, table, pos


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


def test_the_level_table_is_the_spec_and_is_built_once():
    spec = _spec()
    t = spec.level_table("cpu")
    assert t.dtype == torch.int32 and t.shape == (6, 4)
    assert t.tolist() == [[r, n, o, int((r + 1) ** 3 <= n)] for r, n, o in
                          zip(spec.resolutions, spec.level_sizes, spec.offsets)]
    assert spec.level_table(torch.device("cpu")) is t


def test_the_forward_equals_hash_encode():
    spec, table, pos = _inputs()
    kernels.reset_launches()
    got = hg.hash_grid(table, pos, spec)
    assert torch.equal(got, hash_encode(table, pos, spec))
    assert not kernels.launches  # a CPU tensor takes the twin


@pytest.mark.parametrize("need", ["both", "table", "positions"])
def test_the_gradients_match_autograd_through_hash_encode(need):
    spec, table, pos = _inputs(seed=1)
    g = torch.randn((pos.shape[0], spec.out_dim), generator=torch.Generator().manual_seed(2))
    grads = []
    for fn in (hash_encode, hg.hash_grid):
        t = table.clone().requires_grad_(need in ("both", "table"))
        p = pos.clone().requires_grad_(need in ("both", "positions"))
        fn(t, p, spec).backward(g)
        grads.append((t.grad, p.grad))
    (rt, rp), (gt, gp) = grads
    if need == "positions":
        assert gt is None
    else:
        assert torch.equal(gt, rt)
    if need == "table":
        assert gp is None
    else:
        assert torch.equal(gp, rp)
        outside = (pos < 0.0) | (pos > 1.0)
        assert bool((gp[outside] == 0).all()) and bool((rp[outside] == 0).all())  # clamp's derivative


def test_jvp_matches_forward_mode_through_hash_encode():
    spec, table, pos = _inputs(seed=3)
    g = torch.Generator().manual_seed(4)
    tan, table_tan = torch.randn(pos.shape, generator=g), torch.randn(table.shape, generator=g)
    out, want = torch.func.jvp(lambda p: hash_encode(table, p, spec), (pos,), (tan,))
    got_out, got = torch.func.jvp(lambda p: hg.hash_grid(table, p, spec), (pos,), (tan,))
    assert torch.equal(got_out, out) and torch.equal(got, want)
    _, want = torch.func.jvp(lambda t, p: hash_encode(t, p, spec), (table, pos), (table_tan, tan))
    _, got = torch.func.jvp(lambda t, p: hg.hash_grid(t, p, spec), (table, pos), (table_tan, tan))
    assert _rel(got, want) <= GRAD_RTOL


def test_a_cuda_launcher_refuses_a_cpu_tensor():
    """The kernel's wrappers never run the twin: a tensor off the card is
    refused, as are features other than the kernel's two a level."""
    spec, table, pos = _inputs(n=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hg._kernel_forward(table, pos, spec)
    wide = HashGridSpec(num_levels=2, features_per_level=4, log2_hashmap_size=8, min_res=4, max_res=8)
    with pytest.raises(ValueError, match="2 features a level"):
        hg._kernel_table_grad(wide.init_table(), pos, torch.zeros(8, wide.out_dim), wide)


def _bench_cell(traffic=None):
    """The benchmark's hash cell at its tiny size on the CPU."""
    from benchmark import run as bench_run

    cell = "sdf-nerfacto-hashgrid.pretrain"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    sizes = json.loads((ROOT / "benchmark" / "tiny" / f"{cell}.json").read_text())
    sizes["traffic"].update(traffic or {})
    return bench_run.Run(cell, 3000000017, 0.0, False, torch.device("cpu"), bench, sizes)


def test_two_train_steps_of_a_tiny_hash_model_match_the_reference():
    """Two steps of the port's `make_train_step` (`nerf_iteration`) on the
    tiny hash model against the benchmark's plain reference model from the
    same weights and draws: each loss, the first gradient and the change,
    by the worst leaf (`benchmark/compare.training_numbers`)."""
    from benchmark.drivers.pretrain import Driver

    d = Driver(_bench_cell({"warmup_steps": 2, "check_steps": 2}))
    d.setup()
    d.release()
    numbers = d.check()
    assert numbers["loss_gap"] <= 1e-6 and numbers["grad_gap"] <= 1e-6 and numbers["change_gap"] <= 1e-6, numbers
    assert {"field.hash_table", "proposal_0.hash_table", "proposal_1.hash_table"} <= set(numbers["_kept"])


def test_the_spans_and_counters_of_a_traced_step():
    """With the port's tracing on, a training forward and backward of the
    tiny hash model opens `encoding.forward` and `encoding.backward` once
    a grid and counts its points, lookups (the yardstick's unit) and the
    points through the backward; off, it records nothing."""
    from benchmark import roofline
    from benchmark.drivers.common import model_kwargs
    from nerf_emitter_tpu_torch.cameras.rays import RayBundle
    from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel

    cfg = _bench_cell().config
    kw = model_kwargs(cfg, 4)
    model = NerfactoModel(kw.pop("aabb"), device="cpu", **kw)
    rays = 32
    g = torch.Generator().manual_seed(5)
    d = torch.randn((rays, 3), generator=g)
    bundle = RayBundle(origins=-2.0 * d / d.norm(dim=-1, keepdim=True), directions=d / d.norm(dim=-1, keepdim=True),
                       pixel_area=torch.full((rays, 1), 1e-4), nears=torch.full((rays, 1), 0.05),
                       fars=torch.full((rays, 1), 4.0), camera_indices=torch.zeros((rays, 1), dtype=torch.long))

    def step():
        out = model(bundle, train=True, generator=torch.Generator().manual_seed(6))
        (out["rgb"].sum() + sum(w.sum() for w in out["weights_list"])).backward()

    was = profiler.enabled()
    profiler.reset()
    try:
        step()
        assert profiler.counters() == {} and profiler.spans() == {}
        profiler.enable()
        step()
        counts, spans = profiler.counters(), profiler.spans()
    finally:
        profiler.enable(was)
        profiler.reset()
    points = rays * (sum(cfg["model"]["num_proposal_samples"]) + cfg["model"]["num_nerf_samples"])
    assert counts == {"encoding.points": points, "encoding.grad_points": points,
                      "encoding.lookups": rays * roofline.encoding_work(cfg)["lookups"]}
    assert spans["encoding.forward"]["calls"] == spans["encoding.backward"]["calls"] == 3
