"""The port's scripts that no JAX test holds, each against the JAX script on
a tiny input: convert_mesh_to_sdf (a 12^3 SDF of a marching-cubes sphere:
the distances within 1e-5, the parity signs equal, the redistanced grid
within 1e-5), forward_gradient (an 8^2 view at spp 2 on JAX's draws: the
primal, the derivative image and the finite differences equal to JAX's
EXRs within rtol 1e-3 and 1e-3 of the image's largest value, the bar of
tests/test_torch_integrator.py's gradients: the warp's terms amplify f32
roundoff), crop_data (transforms.json
equal, the crops within 1e-6) and composite_image (within 1e-6)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.exporter.marching_cubes import marching_cubes, write_obj
from nerf_emitter_tpu.renderer.grid3d import sphere_sdf_grid
from nerf_emitter_tpu.scripts import composite_image as jci
from nerf_emitter_tpu.scripts import convert_mesh_to_sdf as jcm
from nerf_emitter_tpu.scripts import crop_data as jcd
from nerf_emitter_tpu.scripts import forward_gradient as jfg
from nerf_emitter_tpu_torch.scripts import composite_image as tci
from nerf_emitter_tpu_torch.scripts import convert_mesh_to_sdf as tcm
from nerf_emitter_tpu_torch.scripts import crop_data as tcd
from nerf_emitter_tpu_torch.scripts import forward_gradient as tfg
from nerf_emitter_tpu_torch.utils import exr
from test_torch_renderer import j_spp_draws

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sphere_mesh(tmp_path_factory):
    """A marching-cubes sphere of radius 0.3 (16^3 grid) as an OBJ."""
    path = tmp_path_factory.mktemp("mesh") / "sphere.obj"
    verts, faces = marching_cubes(np.asarray(sphere_sdf_grid(16, radius=0.3)))
    write_obj(path, verts, faces)
    return path, verts, faces


def test_mesh_distance_and_parity_match_jax(sphere_mesh):
    """The unsigned distance on random points (JAX's lax.map against the
    port's chunks, 1e-5) and the parity signs (equal), with points on the
    grid's lines too."""
    _, verts, faces = sphere_mesh
    pts = np.random.default_rng(0).uniform(0, 1, (300, 3)).astype(np.float32)
    tri = verts[faces]
    want = np.asarray(jcm.point_triangle_distance_batch(jnp.asarray(pts), jnp.asarray(tri)))
    got = tcm.point_triangle_distance_batch(torch.from_numpy(pts), torch.from_numpy(tri.astype(np.float32)), batch=64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    xs = np.linspace(0, 1, 9, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1).reshape(-1, 3)
    for p in (pts, grid):
        np.testing.assert_array_equal(tcm.sign_by_parity(p, verts, faces), jcm.sign_by_parity(p, verts, faces))


def test_convert_mesh_to_sdf_matches_jax(sphere_mesh, tmp_path):
    path = sphere_mesh[0]
    for mod, out, extra in ((jcm, "j.npy", []), (tcm, "t.npy", ["--device", "cpu"])):
        mod.main([str(path), "--resolution", "12", "--offset", "0.01", "--out", str(tmp_path / out), *extra])
    want, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.shape == want.shape == (12, 12, 12, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got < 0).sum() > 20  # the sphere's inside


def test_forward_gradient_matches_jax(tmp_path, monkeypatch):
    """--axis x at 8^2, spp 2, on a 17^3 sphere: the port on JAX's draws
    (render_spp's key split per sample) writes JAX's three images (rtol
    1e-3, atol 1e-3 of the largest value) and a report within 1e-3. The
    JAX script runs with its render_spp jitted (eager, it takes a minute)."""
    import nerf_emitter_tpu.renderer.integrator as ji
    from nerf_emitter_tpu.renderer.emitters import EnvmapEmitter
    from nerf_emitter_tpu.renderer.scene import SdfScene

    np.save(tmp_path / "sdf.npy", np.asarray(sphere_sdf_grid(17, radius=0.25)))
    res, spp = 8, 2
    argv = ["--axis", "x", "--resolution", str(res), "--spp", str(spp), "--sdf-volume", str(tmp_path / "sdf.npy")]
    monkeypatch.setattr(ji, "render_spp", jax.jit(ji.render_spp, static_argnums=(4,),
                                                  static_argnames=("config", "emitter_fn", "remat")))
    jfg.main([*argv, "--out", str(tmp_path / "j")])
    jscene = SdfScene.create(sdf_res=17, tex_res=8, envmap=EnvmapEmitter.create(jnp.ones((16, 32, 3))))
    draws = j_spp_draws(jax.random.PRNGKey(0), jscene, res * res, spp)
    report = tfg.main([*argv, "--out", str(tmp_path / "t"), "--device", "cpu"], draws=draws)
    for name in ("primal", "forward_ad", "finite_diff"):
        want, got = (exr.read_exr(tmp_path / side / f"{name}.exr") for side in "jt")
        assert got.shape == (res, res, 3) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    want = json.loads((tmp_path / "j" / "report.json").read_text())
    assert report == json.loads((tmp_path / "t" / "report.json").read_text())
    assert report["axis"] == want["axis"] == "x" and np.abs(report["mean_abs_ad"]) > 0.1
    for k in ("mean_abs_ad", "mean_abs_fd", "mean_rel_error"):
        np.testing.assert_allclose(report[k], want[k], rtol=1e-3)


def test_forward_gradient_tangent_is_the_derivative():
    """The double-backward tangent summed over the image equals a plain
    backward of the image's sum, along x; along the albedo offset (the
    render is linear in it) it equals the central differences."""
    from nerf_emitter_tpu_torch.renderer.integrator import RenderConfig, draw_direct, render_spp

    scene, o, d = tfg.setup(6, np.asarray(sphere_sdf_grid(17, radius=0.25)), "cpu")
    draws = draw_direct(scene, o.shape[0], torch.Generator().manual_seed(1), lead=(2,))
    primal, tangent, fd = tfg.forward_gradient(scene, o, d, "rho", 2, 1e-2, draws=draws)
    assert primal.shape == tangent.shape == fd.shape == (6, 6, 3)
    np.testing.assert_allclose(tangent.numpy(), fd.numpy(), rtol=1e-3, atol=1e-4)
    assert float(tangent.abs().max()) > 0.01
    _, tangent, _ = tfg.forward_gradient(scene, o, d, "x", 2, 1e-3, draws=draws)
    value = torch.zeros((), requires_grad=True)
    render_spp(tfg.apply_param(scene, "x", value), o, d, 2, draws=draws, config=RenderConfig(),
               remat=False)["rgb"].sum().backward()
    np.testing.assert_allclose(float(tangent.sum()), float(value.grad), rtol=1e-5)


def _crop_scene(root):
    rng = np.random.default_rng(3)
    frames = []
    for i, eye in enumerate(([0.0, 0.0, 2.0], [1.5, 0.3, 1.2])):
        from nerf_emitter_tpu_torch.data.synthetic import look_at

        c2w = look_at(np.array(eye, np.float32), np.zeros(3))
        exr.write_exr(root / f"v{i}.exr", rng.uniform(0, 2, (20, 24, 3)).astype(np.float32), half=False)
        frames.append({"file_path": f"v{i}.exr", "transform_matrix": np.asarray(c2w).tolist()})
    frames[1] |= {"fl_x": 30.0, "fl_y": 31.0, "cx": 11.0, "cy": 9.5}
    (root / "transforms.json").write_text(json.dumps({"fl_x": 25.0, "fl_y": 25.0, "cx": 12.0, "cy": 10.0,
                                                      "frames": frames}))


def test_crop_data_matches_jax(tmp_path):
    _crop_scene(tmp_path)
    for mod, out in ((jcd, "j"), (tcd, "t")):
        mod.main([str(tmp_path), "--out", str(tmp_path / out), "--aabb", "-0.3", "-0.2", "-0.3", "0.3", "0.4", "0.3",
                  "--padding", "0.2"])
    meta = {s: json.loads((tmp_path / s / "transforms.json").read_text()) for s in "jt"}
    assert meta["t"] == meta["j"]
    sizes = set()
    for fr in meta["t"]["frames"]:
        want, got = (exr.read_exr(tmp_path / s / fr["file_path"]) for s in "jt")
        assert got.shape == want.shape == (fr["h"], fr["w"], 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        sizes.add(got.shape)
    assert all(h < 20 or w < 24 for h, w, _ in sizes)  # something was cropped
    u = tcd.project_aabb(np.eye(4)[:3], 10.0, 10.0, 5.0, 5.0, np.array([[-1, -1, -3], [1, 1, -2]], np.float32))
    assert u == jcd.project_aabb(np.eye(4)[:3], 10.0, 10.0, 5.0, 5.0, np.array([[-1, -1, -3], [1, 1, -2]], np.float32))


@pytest.mark.parametrize("occlusion", [False, True])
def test_composite_image_matches_jax(tmp_path, occlusion):
    rng = np.random.default_rng(4)
    dirs = ["render", "mask", "bg", "occ", "occ_mask"]
    for d in dirs:
        (tmp_path / d).mkdir()
        for name in ("a.exr", "b.exr"):
            c = 1 if "mask" in d else 3
            exr.write_exr(tmp_path / d / name, rng.uniform(0, 1, (6, 7, c)).astype(np.float32), half=False)
    argv = ["--render-dir", str(tmp_path / "render"), "--mask-dir", str(tmp_path / "mask"), "--background-dir",
            str(tmp_path / "bg")]
    if occlusion:
        argv += ["--occlusion-dir", str(tmp_path / "occ"), "--occlusion-mask-dir", str(tmp_path / "occ_mask")]
    for mod, out in ((jci, "j"), (tci, "t")):
        mod.main([*argv, "--out", str(tmp_path / out)])
    for name in ("a.exr", "b.exr"):
        want, got = (exr.read_exr(tmp_path / s / name) for s in "jt")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["texture", "convert_mesh_to_sdf", "forward_gradient"])
def test_device_tools_need_a_card(tmp_path, name):
    """Without --device cpu the device tools run on CUDA, and raise where
    there is none (never a quiet fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from nerf_emitter_tpu_torch.scripts import texture

    main, argv = {
        "texture": (texture.main, ["--input-mesh", str(tmp_path / "m.obj"), "--albedo-volume", str(tmp_path / "a.npy"),
                                   "--output-dir", str(tmp_path / "out")]),
        "convert_mesh_to_sdf": (tcm.main, [str(tmp_path / "m.obj"), "--out", str(tmp_path / "s.npy")]),
        "forward_gradient": (tfg.main, ["--out", str(tmp_path / "out")]),
    }[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not any(tmp_path.iterdir())
