"""The port's emitter query against the JAX package: the staged query, K3
then K4 (the JAX two-kernel query) and make_nerf_emitter_fn, on one set of weights (one JAX
`model.init` carried across by the bridge) and numpy-made rays.

On the CPU the port's kernel wrappers run their plain twins and the JAX
Pallas kernels run in interpret mode."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.rays import RayBundle as JRayBundle
from nerf_emitter_tpu.models.nerfacto import NerfactoModel as JModel
from nerf_emitter_tpu.ops.fused_field import make_fused_radiance_query as j_staged_query
from nerf_emitter_tpu.ops.mega_query import make_mega_radiance_query as j_mega_query
from nerf_emitter_tpu.pipelines.nerf_emitter import make_nerf_emitter_fn as j_emitter
from nerf_emitter_tpu_torch.bridge import load_flax_params
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.models.nerfacto import NerfactoModel
from nerf_emitter_tpu_torch.ops.fused_field import make_fused_radiance_query
from nerf_emitter_tpu_torch.ops.mega_query import make_mega_radiance_query
from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn

torch.set_num_threads(1)

AABB = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
OBJECT_BOX = ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3))
CFG = dict(num_cameras=4, appearance_embedding_dim=8, implementation="freq")


def _rays_np(n, seed=0, near=0.05, far=3.0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    return dict(
        origins=o, directions=d,
        pixel_area=np.full((n, 1), 1e-4, np.float32),
        nears=np.full((n, 1), near, np.float32), fars=np.full((n, 1), far, np.float32),
        camera_indices=np.ones((n, 1), np.int32),
    )


def _pair(samples=(12, 8), nerf=6, n=16):
    """The same weights in both packages."""
    jm = JModel(aabb=AABB, num_nerf_samples=nerf, num_proposal_samples=samples, **CFG)
    r = _rays_np(n)
    jr = JRayBundle(**{k: jnp.asarray(v) for k, v in r.items()})
    params = jm.init(jax.random.PRNGKey(1), jr)
    pm = NerfactoModel(AABB, num_nerf_samples=nerf, num_proposal_samples=samples, device="cpu", **CFG)
    load_flax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm


def _both(r):
    jr = JRayBundle(**{k: jnp.asarray(v) for k, v in r.items()})
    tr = RayBundle(**{k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                      for k, v in r.items()})
    return jr, tr


def test_port_imports_no_jax():
    """A fresh interpreter importing every module of the port and
    chip_smoke.py loads no jax module and nothing of the JAX package; nor
    does any import statement in chip_smoke.py, inside its functions too."""
    code = (
        "import ast, pkgutil, importlib, sys, nerf_emitter_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nerf_emitter_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "def banned(name):\n"
        "    return name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'nerf_emitter_tpu')\n"
        "bad = [m for m in sys.modules if banned(m)]\n"
        "for node in ast.walk(ast.parse(open(chip_smoke.__file__).read())):\n"
        "    if isinstance(node, ast.Import):\n"
        "        bad += [a.name for a in node.names if banned(a.name)]\n"
        "    elif isinstance(node, ast.ImportFrom) and node.module and banned(node.module):\n"
        "        bad.append(node.module)\n"
        "print(len([m for m in sys.modules if m.startswith('nerf_emitter_tpu_torch')]))\n"
        "sys.exit('banned imports: %s' % bad if bad else 0)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.strip()) >= 20  # every submodule was imported


@pytest.mark.parametrize("builder", ["model", "staged", "mega"])
def test_entry_points_default_to_cuda(builder):
    """device=None means CUDA; without a card it raises instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    if builder == "model":
        with pytest.raises(RuntimeError, match="CUDA"):
            NerfactoModel(AABB, **CFG)
        return
    pm = NerfactoModel(AABB, device="cpu", **CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        if builder == "staged":
            make_fused_radiance_query(pm)
        else:
            make_mega_radiance_query(pm, disable_box=OBJECT_BOX)


def test_query_builders_refuse_what_the_kernels_do_not_compute():
    pm = NerfactoModel(AABB, device="cpu", **CFG)
    assert callable(make_mega_radiance_query(pm, device="cpu"))  # K5 is ported
    for switch in ({"pipelined": False}, {"mxu_chunk": 1}):  # the reference's switches are gone
        with pytest.raises(TypeError):
            make_mega_radiance_query(pm, device="cpu", **switch)
    nonlinear = NerfactoModel(AABB, device="cpu", use_fake_contraction=False, **CFG)
    for build in (make_fused_radiance_query, make_mega_radiance_query):
        with pytest.raises(ValueError, match="fake_contraction"):
            build(nonlinear, device="cpu")
    hashed = NerfactoModel(AABB, device="cpu", num_cameras=4, appearance_embedding_dim=8,
                           implementation="hash")
    for build in (make_fused_radiance_query, make_mega_radiance_query):
        with pytest.raises(ValueError, match="freq-only"):
            build(hashed, device="cpu")


@pytest.mark.parametrize("box", [None, OBJECT_BOX], ids=["nobox", "carveout"])
def test_staged_query_matches_jax(box):
    """Port staged query vs JAX make_fused_radiance_query (twins vs Pallas
    interpret; same algorithm, so a tight bar) and vs JAX model.apply
    (recurrence vs direct sin/cos and kernel vs flax bias rounding: the
    JAX suite's rtol 2e-2, atol 1e-4)."""
    jm, params, pm = _pair()
    jr, tr = _both(_rays_np(16))
    jbox = None if box is None else jnp.asarray(box)
    ref_k = j_staged_query(jm, disable_box=box)(params, jr, camera_index=jnp.int32(1))
    ref_m = jm.apply(params, jr, train=False, hdr_radiance_only=True,
                     disable_aabb=jbox, disable_aabb_on=box is not None)["rgb"]
    query = make_fused_radiance_query(pm, disable_box=box, device="cpu")
    out = query(pm, tr, camera_index=1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_k), rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_m), rtol=2e-2, atol=1e-4)

    # gradients w.r.t. the origins recompute through the twins, as JAX's
    # custom_vjp recomputes through its plain reference. They sum large
    # per-sample terms (the top octave scales by 2^9 * 2pi) whose bf16-rounded
    # cotangents round at other points in the two frameworks: JAX's own
    # staged and model.apply gradients differ by ~50% of the largest
    # component on these inputs. The bar is 15% of the largest component.
    o = tr.origins.clone().requires_grad_()
    g = torch.autograd.grad(query(pm, tr.replace(origins=o), camera_index=1).sum(), o)[0]
    jg = np.asarray(jax.grad(lambda x: jnp.sum(j_staged_query(jm, disable_box=box)(
        params, jr.replace(origins=x), camera_index=jnp.int32(1))))(jr.origins))
    assert torch.isfinite(g).all()
    assert np.abs(g.numpy() - jg).max() <= 0.15 * np.abs(jg).max()


def _k3_then_k4(pm, tr, box, samples, nerf, with_aux=False):
    """The port's K3, then K4 on K3's bins, on tr's rays (camera 1's
    appearance vector, f-major first-layer rows): rgb (3, n), and with
    `with_aux` K4's (4, n) aux."""
    from nerf_emitter_tpu_torch.ops import fused_field as tff
    from nerf_emitter_tpu_torch.ops import mega_query as tmq

    p = tff.named_params(pm)
    rows = [t.T.contiguous() for t in (tr.origins, tr.directions, tr.nears, tr.fars)]
    kw = dict(aabb_lo=(-1.5,) * 3, aabb_inv_ext=(1 / 3,) * 3, disable_box=box, avg_density=1.0)
    (ws0, bs0), (ws1, bs1) = tff._mlp_params(p, "proposal_0.mlp"), tff._mlp_params(p, "proposal_1.mlp")
    bws, bbs = tff._mlp_params(p, "field.base_mlp")
    hws, hbs = tff._mlp_params(p, "field.head_mlp")
    with torch.no_grad():
        sbins = tmq.proposal_bins(*rows, tff.permute_first(ws0, 4), bs0, tff.permute_first(ws1, 6), bs1,
                                  s0=samples[0], s1=samples[1], s2=nerf, freqs0=4, freqs1=6, **kw)
        return tmq.field_composite(sbins, *rows, p["field.appearance_embedding.weight"][1],
                                   tff.permute_first(bws, 10), bbs, hws, hbs, s2=nerf, freqs=10, hdr=True,
                                   rgb_bias=0.0, with_aux=with_aux, **kw)


def test_two_kernel_query_matches_jax_and_staged():
    """The port's K3, then K4 on K3's bins, vs JAX
    make_mega_radiance_query(pipelined=False) at n=150 (tile padding on
    the JAX side), and vs the port's staged query at the JAX bar of
    tests/test_fields.py (rtol 3e-2, atol 1e-3). The inverse CDF differs in
    form (segment walk vs telescoped ramps, ~1e-4 of the spacing range)."""
    jm, params, pm = _pair(n=150)
    jr, tr = _both(_rays_np(150, seed=3))
    ref = j_mega_query(jm, pipelined=False)(params, jr, camera_index=jnp.int32(1))
    out = _k3_then_k4(pm, tr, None, (12, 8), 6).T
    assert out.shape == (150, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-2, atol=1e-3)
    staged = make_fused_radiance_query(pm, device="cpu")(pm, tr, camera_index=1)
    np.testing.assert_allclose(out.numpy(), staged.detach().numpy(), rtol=3e-2, atol=1e-3)


def _x_unit_d(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.35, 0.65, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return x, d


@pytest.mark.parametrize("use_fused", [True, False], ids=["kernel_query", "model_forward"])
def test_emitter_fn_matches_jax(use_fused):
    """make_nerf_emitter_fn in both packages on the same (x_unit, d), with
    the object-box carve-out; on the CPU both serve the query through the
    model's forward. The port's kernel query on the CPU (twins) is held to
    the JAX emitter at the mega bar.

    far=4: at the default far=1e3 the last (background) sample sits ~500
    units out, where one ulp of its warped spacing bin moves it by ~0.03
    units and scrambles the top octaves of its encoding; any two
    implementations of the sampler then disagree on that sample's colour
    (measured here: 6-7% on some rays, JAX against the port)."""
    jm, params, pm = _pair(samples=(16, 8), nerf=8)
    x, d = _x_unit_d(64, seed=5)
    far = 4.0
    ref = j_emitter(jm, 1.0, jnp.asarray(OBJECT_BOX), far=far)(params, camera_index=1)(
        jnp.asarray(x), jnp.asarray(d))
    fn = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, far=far, use_fused=use_fused)(camera_index=1)
    if use_fused:  # on the CPU the builder keeps the model path; drive the kernel query directly
        from nerf_emitter_tpu_torch.ops.colliders import aabb_far_intersect_collider
        from nerf_emitter_tpu_torch.utils.coords import unit_to_world

        o = unit_to_world(torch.from_numpy(x), 1.0)
        tr = RayBundle(origins=o, directions=torch.from_numpy(d),
                       pixel_area=torch.full((64, 1), 1e-4), nears=torch.zeros(64, 1),
                       fars=torch.full((64, 1), far), camera_indices=torch.ones(64, 1, dtype=torch.long))
        tr = aabb_far_intersect_collider(tr, torch.tensor(OBJECT_BOX), far=far)
        out = make_mega_radiance_query(pm, disable_box=OBJECT_BOX, device="cpu")(pm, tr, camera_index=1)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=3e-2, atol=1e-3)
    else:
        out = fn(torch.from_numpy(x), torch.from_numpy(d))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=2e-3, atol=1e-5)
    assert out.shape == (64, 3)


@pytest.mark.parametrize("detach_nerf", [True, False], ids=["frozen", "trained"])
def test_emitter_fn_vjp_matches_jax(monkeypatch, detach_nerf):
    """make_nerf_emitter_fn on the freq model through the model's forward
    in chunks (`_ChunkedQuery`: RECOMPUTE_RAYS at 16, 45 rays, so three
    chunks and a padded one), with the NeRF frozen and trained, given a
    cotangent: the radiance against the JAX emitter at
    test_emitter_fn_matches_jax's model-forward bar (far=4, as there); the
    gradients of x and d against the same call in one chunk, equal (measured:
    0), and against jax.vjp through the JAX emitter (its parameters held)
    by the relative L2 norm over the rays at 5e-2. The freq field's top
    octave, 2^9 times its lowest, scales a rounding of the sample's
    position by as much in its derivative, so the two frameworks'
    gradients part by 2.5% in norm (measured, in one chunk and in chunks
    alike; single rays up to 2x), where the radiance parts by 1.7e-3."""
    from nerf_emitter_tpu_torch.ops import mega_query

    jm, params, pm = _pair(samples=(16, 8), nerf=8)
    x, d = _x_unit_d(45, seed=15)
    g = np.random.default_rng(16).uniform(size=(45, 3)).astype(np.float32)
    ref, vjp = jax.vjp(j_emitter(jm, 1.0, jnp.asarray(OBJECT_BOX), far=4.0)(params, camera_index=1),
                       jnp.asarray(x), jnp.asarray(d))
    answers = []
    for chunk in (16, 1 << 16):
        monkeypatch.setattr(mega_query, "RECOMPUTE_RAYS", chunk)
        tx, td = torch.from_numpy(x).requires_grad_(), torch.from_numpy(d).requires_grad_()
        out = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, far=4.0, use_fused=False, detach_nerf=detach_nerf)(
            camera_index=1)(tx, td)
        answers.append((out.detach(), *torch.autograd.grad(out, (tx, td), torch.from_numpy(g))))
    (out, *got), whole = answers
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=1e-5)
    for a, b, c in zip(got, whole[1:], vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
        c = np.asarray(c)
        assert np.linalg.norm(a.numpy() - c) <= 5e-2 * np.linalg.norm(c)


def test_two_kernel_query_splits_off_the_background():
    """K4's aux output (acc, rgb_last per ray) on the bins K3 gives the
    query's rays reproduces the query's (K5's) answer exactly and splits it
    into the foreground sum(w rgb) and the background term rgb_last (1 - acc);
    foreground and accumulation are held to JAX model.apply with a black
    background at the mega bar (rtol 3e-2, atol 1e-3). far=4, as in
    test_emitter_fn_matches_jax."""
    from nerf_emitter_tpu_torch.ops.colliders import aabb_far_intersect_collider
    from nerf_emitter_tpu_torch.utils.coords import unit_to_world

    jm, params, pm = _pair(samples=(16, 8), nerf=8)
    n, far = 128, 4.0
    x, d = _x_unit_d(n, seed=6)
    tr = RayBundle(origins=unit_to_world(torch.from_numpy(x), 1.0), directions=torch.from_numpy(d),
                   pixel_area=torch.full((n, 1), 1e-4), nears=torch.zeros(n, 1),
                   fars=torch.full((n, 1), far), camera_indices=torch.ones(n, 1, dtype=torch.long))
    tr = aabb_far_intersect_collider(tr, torch.tensor(OBJECT_BOX), far=far)
    with torch.no_grad():
        out = make_mega_radiance_query(pm, disable_box=OBJECT_BOX, device="cpu")(pm, tr, camera_index=1)
    rgb, aux = _k3_then_k4(pm, tr, OBJECT_BOX, (16, 8), 8, with_aux=True)
    assert torch.equal(rgb.T, out)
    fg, acc = (rgb - aux[1:] * (1.0 - aux[:1])).T, aux[0]
    jr = JRayBundle(**{k: jnp.asarray(v.numpy()) for k, v in vars(tr).items() if v is not None})
    ref = jm.clone(background_color="black").apply(
        params, jr, train=False, disable_aabb=jnp.asarray(OBJECT_BOX), disable_aabb_on=True)
    np.testing.assert_allclose(fg.numpy(), np.asarray(ref["rgb"]), rtol=3e-2, atol=1e-3)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref["accumulation"])[:, 0], rtol=3e-2, atol=1e-3)
    assert float(acc.min()) < 0.99  # the background term is there to be split off


def test_emitter_fn_options():
    _, _, pm = _pair(samples=(16, 8), nerf=8)
    with pytest.raises(ValueError, match="multiples of 8"):
        make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, samples_override=(16, 12, 8))
    x, d = _x_unit_d(8, seed=2)
    x = torch.from_numpy(x)
    d = torch.from_numpy(d)
    small = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, samples_override=(8, 8, 8))()(x, d)
    assert small.shape == (8, 3) and torch.isfinite(small).all()
    assert pm.num_proposal_samples == (16, 8)  # the override leaves the model as it was

    # detach_nerf: the radiance still carries the geometry gradient, the
    # NeRF parameters get none
    xg = x.clone().requires_grad_()
    make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, detach_nerf=True)()(xg, d).sum().backward()
    assert all(p.grad is None for p in pm.parameters())
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX)()(x, d).sum().backward()
    assert pm.field.base_mlp.hidden_0.weight.grad is not None
