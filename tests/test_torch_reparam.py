"""The port's warp-field reparameterisation against the JAX package: the
primal is the unwarped direction and the jacobian exactly 1, and the
gradients of the warped direction and the jacobian with respect to the SDF
values, the origins and the directions agree with JAX's (its two jvps of
the velocity field, then the backward through them).

The JAX suite checks the warp against finite differences in slow tests;
this one holds the port's gradient against JAX's at a small size."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nerf_emitter_tpu.renderer import reparam as jr
from nerf_emitter_tpu.renderer import sphere_trace as jst
from nerf_emitter_tpu.renderer.grid3d import sphere_sdf_grid
from nerf_emitter_tpu_torch.renderer import integrator as ti
from nerf_emitter_tpu_torch.renderer import reparam as tr
from nerf_emitter_tpu_torch.renderer import sphere_trace as tst
from nerf_emitter_tpu_torch.renderer.scene import SdfScene
from nerf_emitter_tpu_torch.utils.math import normalize
from test_torch_renderer import TRACE, pinhole_rays, t_

torch.set_num_threads(1)

GRID = 17


def _inputs():
    """A sphere (radius 0.22) and 64 rays around its silhouette."""
    sdf = np.asarray(sphere_sdf_grid(GRID, radius=0.22))
    o, d = pinhole_rays(8, cam=(0.5, 0.5, -0.6))
    return sdf, o, d


def test_reparam_primal_is_the_unwarped_direction():
    """d_warped is normalize(d) bit for bit and the jacobian exactly 1 (the
    warp adds V - detach(V) = 0); d_warped is d within normalize's 1-ulp
    rounding. A warped render's primal equals the soft one's within 1e-5,
    JAX's own bar."""
    sdf, o, d = _inputs()
    cfg = tst.SphereTraceConfig(**TRACE)
    s = t_(sdf).requires_grad_()
    d_w, jac = tr.reparam_direction(s, t_(o), t_(d), cfg, tr.WarpConfig())
    assert torch.equal(d_w.detach(), normalize(t_(d))) and bool((jac == 1.0).all())
    torch.testing.assert_close(d_w.detach(), t_(d), rtol=0.0, atol=1e-6)
    scene = SdfScene(sdf=t_(sdf), albedo=torch.zeros((8, 8, 8, 3)), roughness=torch.full((8, 8, 8, 1), 0.5))
    draws = ti.draw_direct(scene, o.shape[0], torch.Generator().manual_seed(0))

    def white(x, dd):
        return torch.ones_like(dd)

    outs = {rp: ti.render_direct(scene, t_(o), t_(d), draws=draws, emitter_fn=white,
                                 config=ti.RenderConfig(trace=cfg, reparam=rp)) for rp in ("soft", "warp")}
    for k in ("rgb", "depth"):
        torch.testing.assert_close(outs["warp"][k], outs["soft"][k], rtol=0.0, atol=1e-5)


def test_reparam_gradients_match_jax():
    """The gradient of a weighted sum of the warped directions and the
    jacobian with respect to the SDF values and the directions (the
    origins are read detached: no gradient on either side): relative L2
    within 1e-3 of JAX's and cosine above 0.99999, for the default
    WarpConfig (its scale and background distance from the grid's voxel)."""
    sdf, o, d = _inputs()
    rng = np.random.default_rng(0)
    w_d = rng.normal(size=d.shape).astype(np.float32)
    w_j = rng.normal(size=d.shape[:1]).astype(np.float32)
    jcfg, tcfg = jst.SphereTraceConfig(**TRACE), tst.SphereTraceConfig(**TRACE)

    def jloss(s, o_, d_):
        d_w, jac = jr.reparam_direction(s, o_, d_, jcfg, jr.WarpConfig())
        return jnp.sum(d_w * w_d) + jnp.sum(jac * w_j)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(sdf), jnp.asarray(o), jnp.asarray(d))
    args = [t_(x).requires_grad_() for x in (sdf, o, d)]
    d_w, jac = tr.reparam_direction(*args, tcfg, tr.WarpConfig())
    ((d_w * t_(w_d)).sum() + (jac * t_(w_j)).sum()).backward()
    # the warp reads the origins detached, on both sides
    assert args[1].grad is None and not np.asarray(ref[1]).any()
    for a, r in ((args[0], ref[0]), (args[2], ref[2])):
        a, r = a.grad.double().flatten(), torch.from_numpy(np.asarray(r, np.float64)).flatten()
        assert float(r.norm()) > 0
        assert float((a - r).norm() / r.norm()) < 1e-3, float((a - r).norm() / r.norm())
        assert float(a @ r / (a.norm() * r.norm())) > 0.99999
