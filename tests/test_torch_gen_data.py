"""The port's dataset generator against the JAX package's on the same
arguments (the composite object, banded albedo, two light rotations, 4
views of 8^2 at spp 2): transforms.json, the envmaps and the ground-truth
volumes equal, the masks equal but for grazing pixels, and each image equal
to the JAX render when the port is handed JAX's draws; then the port's own
`--resume`, which re-renders only the missing views, bit for bit."""

import json

import jax
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.renderer import grid3d as jgrid
from nerf_emitter_tpu.scripts import gen_data as jgen
from nerf_emitter_tpu_torch.cameras.cameras import Cameras
from nerf_emitter_tpu_torch.renderer.emitters import EnvmapEmitter
from nerf_emitter_tpu_torch.renderer.scene import SdfScene
from nerf_emitter_tpu_torch.scripts import gen_data as tgen
from nerf_emitter_tpu_torch.utils import exr
from test_torch_renderer import j_spp_draws

torch.set_num_threads(1)

ARGS = ["--object", "composite", "--albedo", "bands", "--n-views", "4", "--width", "8", "--height", "8",
        "--spp", "2", "--n-rotations", "2"]
# pixels whose hit the two packages' f32 rounding may decide differently
# (a grazing ray at the silhouette); 4 x 8^2 = 256 pixels in all
GRAZING = 2


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(JAX's dataset dir, the port's) for ARGS."""
    j, t = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    jgen.main(ARGS + ["--out", str(j)])
    tgen.main(ARGS + ["--out", str(t), "--device", "cpu"])
    return j, t


def test_transforms_match_jax(both):
    """Poses, intrinsics, turntable tags and the object box: the JAX
    generator's numpy draws, equal."""
    j, t = (json.loads((d / "transforms.json").read_text()) for d in both)
    assert [f["rotation"] for f in t["frames"]] == [0, 180, 0, 180]
    np.testing.assert_allclose(np.asarray([f["transform_matrix"] for f in t["frames"]]),
                               np.asarray([f["transform_matrix"] for f in j["frames"]]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(t["object_aabb"]), np.asarray(j["object_aabb"]), atol=1e-6, rtol=0)
    assert t == j


@pytest.mark.parametrize("name", ["env.exr", "env_0.exr", "env_180.exr", "gt_albedo.npy", "gt_sdf.npy"])
def test_environment_and_ground_truth_match_jax(both, name):
    """The envmaps and the albedo bit for bit; the SDF within 1e-7 (the
    composite's smooth union is an exp and a log, rounded by each
    library)."""
    j, t = both
    read = np.load if name.endswith(".npy") else exr.read_exr
    a, b = read(t / name), read(j / name)
    assert a.shape == b.shape and a.dtype == b.dtype
    if name == "gt_sdf.npy":
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)
    else:
        np.testing.assert_array_equal(a, b)


def test_masks_match_jax(both):
    j, t = both
    masks = [(exr.read_exr(t / f"r_{i:04d}.exr")[..., 3], exr.read_exr(j / f"r_{i:04d}.exr")[..., 3])
             for i in range(4)]
    assert sum(a.sum() for a, _ in masks) > 20
    assert sum(int((a != b).sum()) for a, b in masks) <= GRAZING


def test_images_match_jax_on_its_draws(both):
    """Each view rendered by the port's render_view on JAX's draws (the
    generator's key split once a call, render_spp's per-sample keys)
    against JAX's render_spp of the same scene, camera and key, as JAX's
    generator calls it: rgb within rtol 1e-4 / atol 1e-5 where the hits
    agree (test_torch_integrator.py's bar); the port's EXR holds its
    render."""
    import jax.numpy as jnp

    from nerf_emitter_tpu.cameras.cameras import Cameras as JCameras
    from nerf_emitter_tpu.renderer.emitters import EnvmapEmitter as JEnvmap
    from nerf_emitter_tpu.renderer.integrator import RenderConfig as JConfig
    from nerf_emitter_tpu.renderer.integrator import render_spp as j_render_spp
    from nerf_emitter_tpu.renderer.scene import SdfScene as JScene
    from nerf_emitter_tpu.renderer.sensors import camera_rays_in_render_space as j_rays

    j, t = both
    meta = json.loads((t / "transforms.json").read_text())
    sdf, albedo = np.load(j / "gt_sdf.npy"), np.load(j / "gt_albedo.npy")
    scene = SdfScene.create(sdf_res=129, tex_res=32).replace(sdf=torch.from_numpy(sdf),
                                                             albedo=torch.from_numpy(albedo))
    jscene = JScene.create(sdf_res=129, tex_res=32).replace(sdf=jnp.asarray(sdf), albedo=jnp.asarray(albedo))
    _, c2ws_render, rots = tgen.camera_poses(4, 2.4, "random", [0.0, 180.0], 0)
    n, f = 4, float(meta["fl_x"])
    c2w = np.stack(c2ws_render)[:, :3]
    cams = Cameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.full((n,), f), fy=torch.full((n,), f),
                   cx=torch.full((n,), 4.0), cy=torch.full((n,), 4.0), width=8, height=8)
    jcams = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.full((n,), f), fy=jnp.full((n,), f),
                     cx=jnp.full((n,), 4.0), cy=jnp.full((n,), 4.0), width=8, height=8)
    key = jax.random.PRNGKey(0)
    for i in range(n):
        key, k = jax.random.split(key)
        env = exr.read_exr(t / f"env_{[0, 180][rots[i]]}.exr")
        js = jscene.replace(envmap=JEnvmap.create(jnp.asarray(env)))
        o, d = j_rays(jcams, jnp.int32(i), 8, 8, 1.0)
        ref = j_render_spp(js, o, d, k, 2, config=JConfig(reparam="soft"), remat=False)
        rgb, mask = tgen.render_view(scene.replace(envmap=EnvmapEmitter.create(torch.from_numpy(env))), cams, i, 2,
                                     draws=[j_spp_draws(k, js, 64, 2)])
        same = mask.numpy().reshape(-1) == np.asarray(ref["hit"], np.float32)
        assert same.mean() >= 1 - GRAZING / 64
        np.testing.assert_allclose(rgb.numpy().reshape(-1, 3)[same], np.asarray(ref["rgb"])[same], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(exr.read_exr(t / f"r_{i:04d}.exr")[..., 3], mask[..., 0].numpy())


@pytest.mark.parametrize("obj", ["sphere", "box"])
def test_primitive_volumes_match_jax(obj):
    sdf, albedo = tgen.gt_volumes(obj, "const")
    want = jgrid.sphere_sdf_grid(129, radius=0.22) if obj == "sphere" else jgrid.box_sdf_grid(129, half_extent=0.18)
    np.testing.assert_allclose(sdf, np.asarray(want), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(albedo, np.full((32, 32, 32, 3), 0.6, np.float32))


def test_resume_rerenders_only_missing_views(tmp_path):
    """--resume after deleting views 1 and 3 renders only those, bit for bit
    (the generator draws the skipped views' numbers), and leaves the others'
    files untouched; an .npy object volume without a channel axis loads."""
    vol = tmp_path / "obj.npy"
    np.save(vol, tgen.gt_volumes("sphere", "const")[0][..., 0])
    out = tmp_path / "scene"
    args = ["--object", str(vol), "--n-views", "4", "--width", "8", "--height", "8", "--spp", "10", "--out",
            str(out), "--device", "cpu"]
    tgen.main(args)
    imgs = sorted(out.glob("r_*.exr"))
    assert len(imgs) == 4
    want = [p.read_bytes() for p in imgs]
    mtimes = [p.stat().st_mtime_ns for p in imgs]
    imgs[1].unlink()
    imgs[3].unlink()
    tgen.main(args + ["--resume"])
    got = sorted(out.glob("r_*.exr"))
    assert [p.read_bytes() for p in got] == want
    assert [got[0].stat().st_mtime_ns, got[2].stat().st_mtime_ns] == [mtimes[0], mtimes[2]]
    assert tgen.spp_calls(10) == (8, 1) and tgen.spp_calls(32) == (8, 4) and tgen.spp_calls(2) == (2, 1)
