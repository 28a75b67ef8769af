"""The port's core math against the JAX package on the same numpy inputs:
ray weights, AABB intersection and the far-intersect collider, spacing
warps, spaced and PDF sampling (deterministic mode), compositing and the
encodings. All float32 elementwise or short reductions: tolerance ~1e-6
(a few ulps; 1e-5 relative where a cumsum or a 2^9 octave is involved)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.cameras.rays import RayBundle as JRayBundle
from nerf_emitter_tpu.data.scene_box import intersect_aabb as j_intersect
from nerf_emitter_tpu.fields import encodings as jenc
from nerf_emitter_tpu.ops import colliders as jcol
from nerf_emitter_tpu.ops import rendering as jren
from nerf_emitter_tpu.ops import samplers as jsam
from nerf_emitter_tpu.ops import spatial_distortions as jsd
from nerf_emitter_tpu.utils import coords as jcoords
from nerf_emitter_tpu.utils import math as jmath
from nerf_emitter_tpu_torch.cameras.rays import RayBundle
from nerf_emitter_tpu_torch.data.scene_box import intersect_aabb
from nerf_emitter_tpu_torch.fields import encodings as tenc
from nerf_emitter_tpu_torch.ops import colliders as tcol
from nerf_emitter_tpu_torch.ops import rendering as tren
from nerf_emitter_tpu_torch.ops import samplers as tsam
from nerf_emitter_tpu_torch.ops import spatial_distortions as tsd
from nerf_emitter_tpu_torch.utils import coords as tcoords
from nerf_emitter_tpu_torch.utils import math as tmath

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _rays(n=32, seed=0, near=0.05, far=6.0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = (0.0, 0.0, 1.0)  # an axis-aligned ray exercises the slab eps
    r = dict(
        origins=rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32), directions=d,
        pixel_area=np.full((n, 1), 1e-4, np.float32),
        nears=rng.uniform(near, 2 * near, size=(n, 1)).astype(np.float32),
        fars=np.full((n, 1), far, np.float32),
        camera_indices=np.zeros((n, 1), np.int32),
    )
    jr = JRayBundle(**{k: jnp.asarray(v) for k, v in r.items()})
    tr = RayBundle(**{k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
                      for k, v in r.items()})
    return jr, tr


def test_math_and_coords():
    x = np.random.default_rng(1).normal(scale=30, size=(64, 3)).astype(np.float32)
    _close(tmath.safe_exp(torch.from_numpy(x), bias=0.5), jmath.safe_exp(jnp.asarray(x), bias=0.5))
    _close(tmath.luminance(torch.from_numpy(x)), jmath.luminance(jnp.asarray(x)), atol=1e-5)
    assert tmath.SAFE_EXP_MAX == jmath.SAFE_EXP_MAX
    _close(tcoords.unit_to_world(torch.from_numpy(x), 1.7), jcoords.unit_to_world(jnp.asarray(x), 1.7))
    _close(tcoords.world_to_unit(torch.from_numpy(x), 1.7), jcoords.world_to_unit(jnp.asarray(x), 1.7))


def test_spatial_distortions():
    x = np.random.default_rng(2).normal(scale=2, size=(64, 3)).astype(np.float32)
    aabb = np.array([[-1.5, -1.0, -2.0], [1.5, 1.0, 2.0]], np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    _close(tsd.fake_contraction(t, torch.from_numpy(aabb)), jsd.fake_contraction(j, jnp.asarray(aabb)))
    _close(tsd.contracted_to_unit(t), jsd.contracted_to_unit(j))
    _close(tsd.scene_contraction(t), jsd.scene_contraction(j))
    _close(tsd.scene_contraction_inf(t), jsd.scene_contraction_inf(j))


def test_intersect_aabb_and_far_collider():
    jr, tr = _rays()
    aabb = np.array([[-0.3, -0.3, -0.3], [0.3, 0.3, 0.3]], np.float32)
    for a, b in zip(intersect_aabb(tr.origins, tr.directions, torch.from_numpy(aabb)),
                    j_intersect(jr.origins, jr.directions, jnp.asarray(aabb))):
        _close(a.float(), np.asarray(b).astype(np.float32))
    tc = tcol.aabb_far_intersect_collider(tr, torch.from_numpy(aabb), far=1e3)
    jc = jcol.aabb_far_intersect_collider(jr, jnp.asarray(aabb), far=1e3)
    _close(tc.nears, jc.nears)
    _close(tc.fars, jc.fars)


@pytest.mark.parametrize("name", ["linear", "reciprocal", "piecewise"])
def test_spacing_functions(name):
    t = np.random.default_rng(3).uniform(1e-3, 50.0, size=(256,)).astype(np.float32)
    fwd, inv = getattr(tsam, f"spacing_{name}"), getattr(tsam, f"spacing_{name}_inv")
    jfwd, jinv = getattr(jsam, f"spacing_{name}"), getattr(jsam, f"spacing_{name}_inv")
    s = fwd(torch.from_numpy(t))
    _close(s, jfwd(jnp.asarray(t)))
    _close(inv(s), jinv(jnp.asarray(s.numpy())))


def test_spaced_and_pdf_sampling_and_weights():
    jr, tr = _rays()
    js = jsam.spaced_sample(jr, 24)
    ts = tsam.spaced_sample(tr, 24)
    for a, b in ((ts.frustums.starts, js.frustums.starts), (ts.frustums.ends, js.frustums.ends),
                 (ts.spacing_starts, js.spacing_starts), (ts.deltas, js.deltas)):
        _close(a, b)
    _close(ts.frustums.get_positions(), js.frustums.get_positions(), atol=1e-5)

    dens = np.random.default_rng(4).gamma(0.5, 2.0, size=(32, 24)).astype(np.float32)
    jw = js.get_weights(jnp.asarray(dens))
    tw = ts.get_weights(torch.from_numpy(dens))
    _close(tw, jw)

    jp = jsam.sample_pdf(jr, js, jw, 16)
    tp = tsam.sample_pdf(tr, ts, tw, 16)
    _close(tp.spacing_starts, jp.spacing_starts, atol=1e-6)
    _close(tp.spacing_ends, jp.spacing_ends, atol=1e-6)
    _close(tp.frustums.starts, jp.frustums.starts, atol=1e-5)


def test_sample_pdf_stops_weight_gradients():
    _, tr = _rays(8)
    ts = tsam.spaced_sample(tr, 8)
    w = torch.rand(8, 8, requires_grad=True)
    out = tsam.sample_pdf(tr, ts, w, 8)
    assert not out.spacing_starts.requires_grad


def test_proposal_sample_matches():
    jr, tr = _rays(16)

    def jdens(pos, cam):
        return jnp.exp(-jnp.sum(pos**2, axis=-1))

    def tdens(pos, cam):
        return torch.exp(-torch.sum(pos**2, dim=-1))

    js, _, _ = jsam.proposal_sample(jr, [jdens, jdens], [32, 16], 8)
    ts, _, _ = tsam.proposal_sample(tr, [tdens, tdens], [32, 16], 8)
    _close(ts.spacing_starts, js.spacing_starts, atol=1e-5)
    _close(ts.frustums.ends, js.frustums.ends, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["median", "expected", "contrib"])
def test_composite(method):
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 3, size=(16, 12, 3)).astype(np.float32)
    w = rng.uniform(0, 0.15, size=(16, 12)).astype(np.float32)
    starts = np.sort(rng.uniform(0.1, 4, size=(16, 12)), axis=-1).astype(np.float32)
    ends = (starts + 0.05).astype(np.float32)
    vals = rng.uniform(size=(16, 12)).astype(np.float32)
    T = torch.from_numpy
    for bg in ("last_sample", "white", "black"):
        _close(tren.composite_rgb(T(rgb), T(w), background_color=bg, hdr=True, is_training=False),
               jren.composite_rgb(jnp.asarray(rgb), jnp.asarray(w), background_color=bg, hdr=True,
                                  is_training=False))
    _close(tren.composite_accumulation(T(w)), jren.composite_accumulation(jnp.asarray(w)))
    _close(
        tren.composite_depth(T(w), T(starts), T(ends), method=method, values=T(vals)),
        jren.composite_depth(jnp.asarray(w), jnp.asarray(starts), jnp.asarray(ends), method=method,
                             values=jnp.asarray(vals)),
    )


@pytest.mark.parametrize("num_freqs", [4, 6, 10])
def test_nerf_encode(num_freqs):
    x = np.random.default_rng(6).uniform(-1, 1, size=(64, 3)).astype(np.float32)
    t = tenc.nerf_encode(torch.from_numpy(x), num_frequencies=num_freqs, max_freq_exp=num_freqs - 1.0)
    j = jenc.nerf_encode(jnp.asarray(x), num_frequencies=num_freqs, max_freq_exp=num_freqs - 1.0)
    # the top octave's argument reaches 2^9 * 2pi: a few ulps of it
    _close(t, j, atol=2e-5)


def test_sh_encode():
    d = np.random.default_rng(7).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for degree in (1, 2, 3, 4):
        _close(tenc.sh_encode(torch.from_numpy(d), degree), jenc.sh_encode(jnp.asarray(d), degree))
