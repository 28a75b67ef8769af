"""The kernel query's backward for a frozen NeRF (ops/mega_query.py): K3's
bins, then the vjp kernel, whose plain version (`_plain_field_composite_vjp`,
autograd through the field/composite twin at given bins) serves the CPU.
Held here against the route it replaces, the recompute through the staged
query, which stays the route whenever a NeRF parameter needs a gradient.

The rays mix origins inside the scene box, inside the carve-out box and
outside the scene box, at far = 4 and at far = 1e3."""

import dataclasses

import pytest
import torch

from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops import fused_field as ff
from nerf_emitter_tpu_torch.ops import mega_query as mq
from nerf_emitter_tpu_torch.ops.samplers import sample_pdf, spaced_sample
from nerf_emitter_tpu_torch.parallel.mesh import fill_rows
from nerf_emitter_tpu_torch.utils import profiler

torch.set_num_threads(1)

AABB = ((-1.5,) * 3, (1.5,) * 3)
CARVE = ((-0.3,) * 3, (0.3,) * 3)
SAMPLES = dict(num_proposal_samples=(16, 8), num_nerf_samples=8)
N = 60
RAY_NAMES = ("origins", "directions", "nears", "fars")


@pytest.fixture(autouse=True)
def tracing_off():
    profiler.disable()
    profiler.reset()
    yield
    profiler.disable()
    profiler.reset()


def _model():
    torch.manual_seed(0)
    return NerfactoModel(AABB, num_cameras=2, appearance_embedding_dim=8, implementation="freq", device="cpu",
                         **SAMPLES)


def _rays(far, n=N):
    """n rays: a third from inside the carve-out box, a third from the scene
    box outside it, a third from outside the scene box; directions on the
    sphere; near 0.05, camera 1."""
    g = torch.Generator().manual_seed(5)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    u = torch.rand((n, 3), generator=g) * 2.0 - 1.0
    scale = torch.tensor([0.25, 1.2, 2.2]).repeat_interleave(-(-n // 3))[:n, None]
    return RayBundle(origins=u * scale, directions=d, pixel_area=torch.full((n, 1), 1e-4),
                     nears=torch.full((n, 1), 0.05), fars=torch.full((n, 1), far),
                     camera_indices=torch.ones((n, 1), dtype=torch.long))


def _grads(query, params, rays, weights):
    """The gradients of sum(weights * answer) with respect to the rays'
    origins, directions, nears and fars."""
    leaves = [getattr(rays, k).clone().requires_grad_() for k in RAY_NAMES]
    out = query(params, dataclasses.replace(rays, **dict(zip(RAY_NAMES, leaves))), camera_index=1)
    return torch.autograd.grad((out * weights).sum(), leaves)


class _Parts:
    """The query's pieces on the CPU, the field frozen."""

    def __init__(self, params):
        self.p = params
        self.cfg = ff._QueryConfig(_model(), CARVE, "cpu")
        ws0, bs0 = ff._mlp_params(params, "proposal_0.mlp")
        ws1, bs1 = ff._mlp_params(params, "proposal_1.mlp")
        bws, bbs = ff._mlp_params(params, "field.base_mlp")
        hws, hbs = ff._mlp_params(params, "field.head_mlp")
        self.ff = ff._freqs_of(bws[0])
        self.box = dict(aabb_lo=self.cfg.aabb_lo, aabb_inv_ext=self.cfg.aabb_inv_ext, disable_box=self.cfg.dbox,
                        avg_density=1.0)
        self.props = (ff.permute_first(ws0, 4), bs0, ff.permute_first(ws1, 6), bs1)
        self.field = (ff.permute_first(bws, self.ff), bbs, hws, hbs)
        self.emb = self.cfg.embedding(params, 1, "cpu")
        self.vjp_kw = dict(s2=8, freqs=self.ff, hdr=self.cfg.hdr, rgb_bias=self.cfg.rgb_bias, **self.box)

    def k3_bins(self, rows):
        return mq.proposal_bins(*rows, *self.props, s0=16, s1=8, s2=8, freqs0=4, freqs1=6, **self.box)

    def staged_bins(self, rays):
        """The staged query's final spacing bins (s2+1, N): its sampler (the
        ramp-sum inverse CDF) on K1's twin's densities."""
        rs, weights = spaced_sample(rays, 16), None
        for lvl in range(2):
            if lvl:
                rs = sample_pdf(rays, rs, weights, 8)
            ws, bs = ff._mlp_params(self.p, f"proposal_{lvl}.mlp")
            mid = (rs.frustums.starts + rs.frustums.ends) / 2.0
            pos = (rays.origins.T[:, :, None] + rays.directions.T[:, :, None] * mid[None]).reshape(3, -1)
            dens = ff._plain_density(pos, ws, bs, num_freqs=ff._freqs_of(ws[0]), **self.box)
            weights = rs.get_weights(dens.reshape(rs.frustums.starts.shape))
        rs = sample_pdf(rays, rs, weights, 8)
        return torch.cat([rs.spacing_starts, rs.spacing_ends[:, -1:]], dim=-1).T.contiguous()

    def vjp(self, sbins, rows, g_t):
        return mq._plain_field_composite_vjp(sbins, *rows, g_t, self.emb, *self.field, **self.vjp_kw)


@pytest.mark.parametrize("far", [4.0, 1e3], ids=["far4", "far1e3"])
def test_vjp_route_against_the_recompute(far):
    """The two routes of the backward differ in one thing, where they put
    the bins: K3 (a CDF walk) and the staged sampler (the reference's ramp
    sum, whose cancellation leaves it ~1e-4 of the spacing range off) agree
    within 3e-4 of the range (1.9e-4 on these rays).

    On the same bins (the staged sampler's) the vjp route's plain version
    gives the recompute's gradients up to rounding: the two encode in other
    orders (f-major against k-major), so the first layer's f32 sums can flip
    a hidden unit's bf16 rounding, which moves a ray's gradient by up to
    ~0.6% of the largest entry (on these rays 0.09-0.10% at far = 4,
    0.13-0.61% at far = 1e3, where the background sample's encoding sits far
    outside the box); held at 1% of each gradient's largest entry.

    Across the two routes' own bins the bar follows from the bins' gap: an
    edge moved by ds moves its sample by dt <= 2 far^2 ds, 9.6e-3 at far = 4
    and ds = 3e-4, which turns the F = 10 field's top octave (2 pi 2^9 per
    unit of its [-1, 1] coordinate, 2/3 of a world unit) by up to 20
    radians: no bar holds at that width (the two routes' gradients differ by
    5-22% of their largest entry). On the same field with its encoding cut
    to the octaves 2^0 and 2^1 (the first layer's other rows zeroed) the
    turn is 2 pi 2 (2/3) 9.6e-3 = 0.080 radian, an 8% change of a term: held
    at 8% of the largest entry at far = 4. At far = 1e3 an edge near the
    background sample (t ~ 500) moves by 2 t^2 ds, ~150 units: no bar
    follows there, and the route is held on equal bins only."""
    model = _model()
    params = {k: v.detach().clone() for k, v in ff.named_params(model).items()}
    parts = _Parts(params)
    rays = _rays(far)
    rows = [getattr(rays, k).T.contiguous() for k in RAY_NAMES]
    g_t = torch.linspace(0.5, 1.5, 3 * N).reshape(3, N)
    staged = ff.make_fused_radiance_query(model, disable_box=CARVE, device="cpu")
    recompute = [t.T for t in _grads(staged.recompute, params, rays, g_t.T)]

    sb_k3, sb_staged = parts.k3_bins(rows), parts.staged_bins(rays)
    assert float((sb_k3 - sb_staged).abs().max()) <= 3e-4

    for name, a, b in zip(RAY_NAMES, parts.vjp(sb_staged, rows, g_t), recompute):
        torch.testing.assert_close(a, b, rtol=0.0, atol=1e-2 * float(b.abs().max()), msg=name)

    if far == 4.0:
        for k in range(3):
            for i in range(2, parts.ff):
                w = params["field.base_mlp.hidden_0.weight"]
                w[:, 3 + k * parts.ff + i] = 0.0
                w[:, 3 + 3 * parts.ff + k * parts.ff + i] = 0.0
        parts = _Parts(params)
        routes = [parts.vjp(sb, rows, g_t) for sb in (sb_k3, parts.staged_bins(rays))]
        for name, a, b in zip(RAY_NAMES, *routes):
            torch.testing.assert_close(a, b, rtol=0.0, atol=8e-2 * float(b.abs().max()), msg=name)


def test_vjp_route_is_batch_independent():
    """The vjp route works ray by ray: the same rays asked whole (300, three
    tiles) and in halves (137 and 163) get equal gradients, bit for bit."""
    query = mq.make_mega_radiance_query(_model(), disable_box=CARVE, device="cpu")
    params = {k: v.detach() for k, v in ff.named_params(_model()).items()}
    n = 300
    rays = _rays(4.0, n)
    weights = torch.linspace(0.5, 1.5, 3 * n).reshape(n, 3)
    whole = _grads(query, params, rays, weights)

    def part(sl):
        sub = RayBundle(**{f.name: getattr(rays, f.name)[sl] for f in dataclasses.fields(rays)
                           if getattr(rays, f.name) is not None})
        return _grads(query, params, sub, weights[sl])

    halves = [part(slice(0, 137)), part(slice(137, n))]
    for name, a, b0, b1 in zip(RAY_NAMES, whole, *halves):
        assert torch.equal(a, torch.cat([b0, b1])), name


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "trained"])
def test_backward_route_follows_the_parameters(frozen):
    """With no NeRF parameter needing a gradient the backward takes the vjp
    route: it counts its rays under emitter.vjp_rays, none under
    emitter.recompute_rays, and its gradients are the plain vjp's on K3's
    twin's bins, bit for bit. With the parameters trained it takes the
    recompute route as before: it counts its chunk, and its gradients, the
    rays' and every parameter's, are those of autograd through the staged
    recompute, bit for bit."""
    model = _model()
    query = mq.make_mega_radiance_query(model, disable_box=CARVE, device="cpu")
    params = {k: v.detach().requires_grad_(not frozen) for k, v in ff.named_params(model).items()}
    rays = _rays(4.0)
    weights = torch.linspace(0.5, 1.5, 3 * N).reshape(N, 3)
    leaves = [getattr(rays, k).clone().requires_grad_() for k in RAY_NAMES]
    profiler.enable()
    out = query(params, dataclasses.replace(rays, **dict(zip(RAY_NAMES, leaves))), camera_index=1)
    wanted = leaves + ([] if frozen else [params[k] for k in sorted(params)])
    got = torch.autograd.grad((out * weights).sum(), wanted, allow_unused=True)
    profiler.disable()
    if frozen:
        assert profiler.counters() == {"emitter.vjp_rays": N}
        parts = _Parts(params)
        n_pad = mq.TILE_RAYS
        rows = [fill_rows(getattr(rays, k), n_pad, mq.RAY_PADS[k]).T.contiguous() for k in RAY_NAMES]
        want = parts.vjp(parts.k3_bins(rows), rows, fill_rows(weights, n_pad, 0.0).T.contiguous())
        want = [t[:, :N].T for t in want]
    else:
        assert profiler.counters() == {"emitter.recompute_chunks": 1, "emitter.recompute_rays": N}
        staged = ff.make_fused_radiance_query(model, disable_box=CARVE, device="cpu")
        again = [getattr(rays, k).clone().requires_grad_() for k in RAY_NAMES]
        with torch.enable_grad():
            ref = staged.recompute(params, dataclasses.replace(rays, **dict(zip(RAY_NAMES, again))), camera_index=1)
        want = torch.autograd.grad((ref * weights).sum(), again + [params[k] for k in sorted(params)],
                                   allow_unused=True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
