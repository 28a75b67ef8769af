"""The port's turntable against the JAX package: every `Rotater`
constructor and method, the model forward with `camera_rot_ids` (and with
learnable rotation deltas), the emitter closure's rotater path, and the
pose-delta gradient of the eval forward.

Rotations are f32 on both sides (measured within 1e-6); the model bars are
the f32 bar of tests/test_torch_hash.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.fields import rotater as jrot
from nerf_emitter_tpu.pipelines.nerf_emitter import make_nerf_emitter_fn as j_emitter
from nerf_emitter_tpu_torch.fields import rotater as trot
from nerf_emitter_tpu_torch.pipelines.nerf_emitter import make_nerf_emitter_fn
from nerf_emitter_tpu_torch.utils import coords
from test_torch_hash import ATOL, OBJECT_BOX, RTOL, _both, _rays_np, hash_pair

torch.set_num_threads(1)

R_ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _close(t, j, atol=R_ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0.0, atol=atol)


def _rotaters(kind):
    """The same rotater in both packages."""
    c = np.array([0.3, 0.1, -0.2], np.float32)
    if kind == "axis_angle":
        return (jrot.Rotater.from_axis_angle(8, center=jnp.asarray(c)),
                trot.Rotater.from_axis_angle(8, center=_t(c)))
    if kind == "tilted_axis":
        axis = np.array([0.48, 0.6, 0.64], np.float32)
        return (jrot.Rotater.from_axis_angle(5, center=jnp.asarray(c), axis=jnp.asarray(axis)),
                trot.Rotater.from_axis_angle(5, center=_t(c), axis=_t(axis)))
    if kind == "angles":
        tags = [0.0, 30.0, 95.0, 270.0]
        return (jrot.Rotater.from_angles(tags, center=jnp.asarray(c)),
                trot.Rotater.from_angles(tags, center=_t(c)))
    j = jrot.Rotater.from_angles([0.0, 40.0, 200.0], center=jnp.asarray(c))
    if kind == "matrices":
        return (jrot.Rotater.from_matrices(j.transforms, jnp.asarray(c)),
                trot.Rotater.from_matrices(np.array(j.transforms), c))
    # learnable deltas (id 0 frozen)
    deltas = np.random.default_rng(0).normal(scale=0.1, size=(3, 6)).astype(np.float32)
    return (j.replace(deltas=jnp.asarray(deltas)),
            trot.Rotater.from_matrices(np.array(j.transforms), c).replace(deltas=_t(deltas)))


KINDS = ["axis_angle", "tilted_axis", "angles", "matrices", "deltas"]


@pytest.mark.parametrize("kind", KINDS)
def test_rotater_methods_match_jax(kind):
    jr, tr = _rotaters(kind)
    n_rot = int(jr.transforms.shape[0])
    _close(tr.transforms, jr.transforms)
    rng = np.random.default_rng(1)
    rid = (np.arange(12) % n_rot).astype(np.int32)
    pts = rng.normal(size=(12, 3)).astype(np.float32)
    dirs = rng.normal(size=(12, 3)).astype(np.float32)
    c2w = rng.normal(size=(12, 3, 4)).astype(np.float32)
    jid, tid = jnp.asarray(rid), torch.from_numpy(rid.astype(np.int64))
    _close(tr.matrix(tid), jr.matrix(jid))
    _close(tr.apply_points(tid, _t(pts)), jr.apply_points(jid, jnp.asarray(pts)))
    _close(tr.apply_dirs(tid, _t(dirs)), jr.apply_dirs(jid, jnp.asarray(dirs)))
    _close(tr.apply_c2w(tid, _t(c2w)), jr.apply_c2w(jid, jnp.asarray(c2w)))
    _close(tr.apply_c2w_inverse(tid, _t(c2w)), jr.apply_c2w_inverse(jid, jnp.asarray(c2w)))
    for radius in (None, 1.0):
        for a, b in zip(tr.apply_rays_within(tid, _t(pts), _t(dirs), radius),
                        jr.apply_rays_within(jid, jnp.asarray(pts), jnp.asarray(dirs), radius)):
            _close(a, b)
    samples = rng.normal(scale=0.6, size=(12, 5, 3)).astype(np.float32)
    sdirs = rng.normal(size=(12, 5, 3)).astype(np.float32)
    for a, b in zip(tr.apply_positions_within(tid, _t(samples), _t(sdirs), 0.7),
                    jr.apply_positions_within(jid, jnp.asarray(samples), jnp.asarray(sdirs), 0.7)):
        _close(a, b)
    p0, d0 = tr.apply_positions_within(tid, _t(samples), None, 0.7)
    assert d0 is None
    # a single id, as the takeover passes it
    _close(tr.apply_points(torch.tensor(1), _t(pts[0])), jr.apply_points(jnp.int32(1), jnp.asarray(pts[0])))


def test_rotater_turntable_identities():
    """The JAX suite's cases (tests/test_tooling.py, tests/test_real_capture.py):
    id 1 of four is 90 degrees about +y (x -> -z), id 0 the identity, the
    centre is fixed, apply_positions_within inverts canonical -> world
    inside the sphere and leaves the outside alone."""
    rot = trot.Rotater.from_axis_angle(4, center=torch.zeros(3))
    p = torch.tensor([1.0, 0.0, 0.0])
    torch.testing.assert_close(rot.apply_points(torch.tensor(1), p), torch.tensor([0.0, 0.0, -1.0]),
                               rtol=0.0, atol=1e-6)
    torch.testing.assert_close(rot.apply_points(torch.tensor(0), p), p, rtol=0.0, atol=1e-6)
    c = torch.tensor([0.3, 0.1, -0.2])
    torch.testing.assert_close(trot.Rotater.from_axis_angle(8, center=c).apply_points(torch.tensor(3), c),
                               c, rtol=0.0, atol=1e-6)
    c2w = torch.cat([torch.eye(3), torch.tensor([[2.0], [0.0], [0.0]])], dim=1)
    torch.testing.assert_close(rot.apply_c2w(torch.tensor(1), c2w)[:, 3], torch.tensor([0.0, 0.0, -2.0]),
                               rtol=0.0, atol=1e-6)
    rid = torch.tensor([1, 2])
    p_canon = torch.tensor([[0.1, 0.05, 0.2], [0.2, 0.0, 0.1]])
    p_world = rot.apply_points(rid, p_canon)
    pos = torch.stack([torch.stack([p_world[0], torch.tensor([3.0, 0.0, 0.0])]),
                       torch.stack([p_world[1], torch.tensor([0.0, 0.0, 4.0])])])
    dirs = torch.tensor([0.0, 0.0, 1.0]).expand(pos.shape)
    out, out_d = rot.apply_positions_within(rid, pos, dirs, bounding_radius=0.5)
    torch.testing.assert_close(out[:, 0], p_canon, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(out[:, 1], pos[:, 1], rtol=0.0, atol=0.0)
    torch.testing.assert_close(out_d[:, 1], dirs[:, 1], rtol=0.0, atol=0.0)
    assert trot.unique_rotation_ids([0, 30, 60, 30, 0]) == jrot.unique_rotation_ids([0, 30, 60, 30, 0])


@pytest.mark.parametrize("scale", [0.0, 1e-5, 0.3, 2.0], ids=["zero", "taylor", "small", "large"])
def test_exp_so3_matches_jax(scale):
    """Both branches (Taylor below theta^2 = 1e-8) and the batched form;
    the gradient at zero is finite."""
    w = (np.random.default_rng(2).normal(size=(6, 3)) * scale).astype(np.float32)
    ref = jax.vmap(jrot.exp_so3)(jnp.asarray(w))
    _close(trot.exp_so3(_t(w)), ref)
    _close(trot.exp_so3(_t(w[0])), jrot.exp_so3(jnp.asarray(w[0])))
    x = _t(w).requires_grad_()
    trot.exp_so3(x).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jax.vmap(jrot.exp_so3)(v)))(jnp.asarray(w))
    _close(x.grad, jg, atol=1e-5)


def _turntable_rays():
    """Rays starting near the turntable centre so that samples fall both
    inside and outside the rotation radius; cameras 0..5."""
    r = _rays_np(24, seed=8, far=2.0)
    r["camera_indices"] = (np.arange(24, dtype=np.int32) % 6)[:, None]
    return r


CAM_ROT_IDS = np.array([0, 1, 2, 3, 1, 2], np.int32)


@pytest.mark.parametrize("learned", [False, True], ids=["rotater", "optimize_rotations"])
def test_model_forward_with_camera_rot_ids_matches_jax(learned):
    """The eval forward with a turntable rotater: samples inside
    rotation_radius inverse-rotated by their camera's rotation id. With
    optimize_rotations the model's own rotation_opt_deltas (random here,
    bridged) correct every id but 0."""
    over = dict(optimize_rotations=True, num_rotations=4) if learned else {}
    jm, params, pm = hash_pair(**over)
    if learned:
        tree = jax.tree.map(np.asarray, params)
        tree["params"]["rotation_opt_deltas"] = np.random.default_rng(9).normal(
            scale=0.1, size=(4, 6)).astype(np.float32)
        params = jax.tree.map(jnp.asarray, tree)
        from nerf_emitter_tpu_torch.bridge import load_flax_params

        load_flax_params(pm, tree)
    jrt = jrot.Rotater.from_axis_angle(4, center=jnp.zeros(3))
    trt = trot.Rotater.from_axis_angle(4, center=torch.zeros(3))
    jr, tr = _both(_turntable_rays())
    ref = jm.apply(params, jr, train=False, rotater=jrt, camera_rot_ids=jnp.asarray(CAM_ROT_IDS),
                   rotation_radius=0.5)
    out = pm(tr, rotater=trt, camera_rot_ids=torch.from_numpy(CAM_ROT_IDS.astype(np.int64)),
             rotation_radius=0.5)
    plain = pm(tr)
    assert not torch.allclose(out["rgb"], plain["rgb"])  # the rotation moved some samples
    for k in ("rgb", "accumulation", "depth"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_emitter_turntable_matches_jax_and_the_rotated_rays():
    """With a rotater the emitter at id 0 is the plain emitter; at id 1 it
    equals the plain emitter on the hand-rotated rays (a 90-degree turn
    maps the object cube onto itself, so the box exit is the same), and
    the JAX emitter with the same rotater (tests/test_pipeline.py)."""
    jm, params, pm = hash_pair()
    rng = np.random.default_rng(10)
    x = rng.uniform(0.4, 0.6, size=(16, 3)).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tx, td = torch.from_numpy(x), torch.from_numpy(d)
    rot = trot.Rotater.from_axis_angle(4, center=torch.zeros(3))
    fn_of = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, far=4.0, rotater=rot)
    plain = make_nerf_emitter_fn(pm, 1.0, OBJECT_BOX, far=4.0)()
    torch.testing.assert_close(fn_of(rot_id=0)(tx, td), plain(tx, td), rtol=1e-5, atol=0.0)
    rid = torch.ones(16, dtype=torch.long)
    x_w = coords.world_to_unit(rot.apply_points(rid, coords.unit_to_world(tx, 1.0)), 1.0)
    rotated = fn_of(rot_id=1)(tx, td)
    torch.testing.assert_close(rotated, plain(x_w, rot.apply_dirs(rid, td)), rtol=1e-5, atol=1e-6)
    ref = j_emitter(jm, 1.0, jnp.asarray(OBJECT_BOX), far=4.0,
                    rotater=jrot.Rotater.from_axis_angle(4, center=jnp.zeros(3)))(
        params, rot_id=jnp.int32(1))(jnp.asarray(x), jnp.asarray(d))
    np.testing.assert_allclose(rotated.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_pose_delta_gradient_matches_jax():
    """d mean(rgb^2) / d camera_opt_deltas of the eval forward against
    jax.grad, at random small deltas (bridged). Every camera the rays use
    gets a gradient. The bar is 1e-4 of the largest component (measured:
    9e-8 of it; the hash field's bf16 roundings land at the same points in
    both frameworks here)."""
    jm, params, pm = hash_pair(optimize_camera_poses=True)
    tree = jax.tree.map(np.asarray, params)
    assert tree["params"]["camera_opt_deltas"].shape == (6, 6)
    tree["params"]["camera_opt_deltas"] = np.random.default_rng(11).normal(
        scale=0.02, size=(6, 6)).astype(np.float32)
    from nerf_emitter_tpu_torch.bridge import load_flax_params

    load_flax_params(pm, tree)
    params = jax.tree.map(jnp.asarray, tree)
    jr, tr = _both(_turntable_rays())
    jg = jax.grad(lambda p: jnp.mean(jm.apply(p, jr, train=False)["rgb"] ** 2))(params)
    jg = np.asarray(jg["params"]["camera_opt_deltas"])
    loss = torch.mean(pm(tr)["rgb"] ** 2)
    loss.backward()
    g = pm.camera_opt_deltas.grad.numpy()
    assert (np.abs(g).sum(axis=1) > 0).all()
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
