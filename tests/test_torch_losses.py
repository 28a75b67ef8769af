"""The port's losses against nerf_emitter_tpu/ops/losses.py: each loss's
value and its gradient with respect to every input against jax.grad, on
numpy-seeded inputs. Every stop_gradient of the reference is a detach in
the port, so the stopped inputs' gradients must be zero on both sides.

Both sides compute in f32; only the reductions' and cumulative sums'
orders differ. The bar is f32 roundoff: values at rtol 1e-5 / atol 1e-7,
gradients at rtol 1e-5 plus 1e-6 of their largest component (the
cumulative sums' reversed sums measured 5e-8 on components of 0.03)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.ops import losses as JL
from nerf_emitter_tpu_torch.ops import losses as TL

torch.set_num_threads(1)

RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-7, 1e-6


def _check(j_fn, t_fn, *arrays):
    """Value and the gradient of every argument, JAX against the port."""
    ref, ref_g = jax.value_and_grad(j_fn, argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = t_fn(*ts)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=RTOL, atol=ATOL)
    for t, g in zip(ts, ref_g):
        got = np.zeros_like(t.detach().numpy()) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=RTOL, atol=GRAD_ATOL * max(1.0, float(np.abs(g).max())))
    return float(ref)


def _levels(n=16, sizes=(12, 8, 6), seed=0):
    """Per-level weights (n, S) and normalised spacing edges (n, S+1):
    random sorted edges from 0 to 1, weights summing to at most 1."""
    rng = np.random.default_rng(seed)
    weights, bins = [], []
    for s in sizes:
        inner = np.sort(rng.uniform(size=(n, s - 1)), axis=-1)
        bins.append(np.concatenate([np.zeros((n, 1)), inner, np.ones((n, 1))], -1).astype(np.float32))
        w = rng.exponential(size=(n, s))
        w[:, rng.integers(0, s)] = 0.0  # empty bins, as opaque surfaces leave
        weights.append((w / w.sum(-1, keepdims=True) * rng.uniform(0.5, 1.0, size=(n, 1))).astype(np.float32))
    return weights, bins


@pytest.mark.parametrize("name", sorted(TL.RGB_LOSSES))
def test_rgb_losses_match_jax(name):
    """Values and d/dpred, d/dgt; pred crosses zero for the relative
    losses' |pred| and max |pred| denominators."""
    rng = np.random.default_rng(1)
    pred = rng.normal(0.5, 0.6, size=(64, 3)).astype(np.float32)
    gt = np.abs(rng.normal(0.5, 0.5, size=(64, 3))).astype(np.float32)
    if name == "rawnerf":
        pred = np.abs(pred)  # its scale sg(pred) + eps is for non-negative HDR predictions
    assert set(TL.RGB_LOSSES) == set(JL.RGB_LOSSES)
    _check(JL.RGB_LOSSES[name], TL.RGB_LOSSES[name], pred, gt)


def test_stopped_denominators_carry_no_gradient():
    """rawnerf's scale and the relative losses' denominators are detached:
    the gradient is exactly that of the numerator over a constant."""
    p = np.array([[0.5, 1.0, 2.0]], np.float32)
    want = {"rawnerf": 2 * p / (p + 1e-3) ** 2 / 3, "relative_l1": 1 / (p + 1e-2) / 3,
            "relative_l2": 2 * p / (p**2 + 1e-2) / 3, "relative_max_l1": 1 / (p.max() + 1e-2) / 3 * np.ones_like(p)}
    for name, grad in want.items():
        pred = torch.tensor(p, requires_grad=True)
        TL.RGB_LOSSES[name](pred, torch.zeros((1, 3))).backward()
        np.testing.assert_allclose(pred.grad.numpy(), grad, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("sizes", [(12, 8, 6), (24, 12, 16)], ids=["shrinking", "fine_wider"])
def test_interlevel_loss_matches_jax(sizes):
    """Three levels (two proposals, then the fine level): the value and the
    gradients of every level's weights and bins. The fine level's are zero
    (stop_gradient / detach), and so are the bins' (a step function of
    them almost everywhere)."""
    weights, bins = _levels(sizes=sizes)

    def j_fn(*a):
        return JL.interlevel_loss(list(a[:3]), list(a[3:]))

    def t_fn(*a):
        return TL.interlevel_loss(list(a[:3]), list(a[3:]))

    value = _check(j_fn, t_fn, *weights, *bins)
    assert value > 1e-3  # the random proposals do under-cover the fine level


def test_outer_keeps_the_reference_form():
    """_outer's masks are (n, S0, S1) per ray and its result equals the
    reference's on the same bins."""
    weights, bins = _levels()
    t, tp, wp = bins[2], bins[0], weights[0]
    ref = JL._outer(*(jnp.asarray(a) for a in (t[:, :-1], t[:, 1:], tp[:, :-1], tp[:, 1:], wp)))
    out = TL._outer(*(torch.from_numpy(a) for a in (t[:, :-1], t[:, 1:], tp[:, :-1], tp[:, 1:], wp)))
    assert out.shape == (16, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_distortion_loss_matches_jax():
    """Value and the gradients of the weights and of both spacing edges."""
    weights, bins = _levels(sizes=(10,))
    w, b = weights[0], bins[0]
    _check(JL.distortion_loss, TL.distortion_loss, w, b[:, :-1], b[:, 1:])


@pytest.mark.parametrize("name", ["orientation_loss", "pred_normal_loss"])
def test_normal_losses_match_jax(name):
    rng = np.random.default_rng(2)
    w = rng.uniform(size=(32, 8)).astype(np.float32)
    normals = rng.normal(size=(32, 8, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    if name == "orientation_loss":
        other = rng.normal(size=(32, 3)).astype(np.float32)
        other /= np.linalg.norm(other, axis=-1, keepdims=True)
    else:
        other = rng.normal(size=(32, 8, 3)).astype(np.float32)
    _check(getattr(JL, name), getattr(TL, name), w, normals, other)
