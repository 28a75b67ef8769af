"""The port's eval, render and export CLIs on a 4-step CPU run of
sdf-nerfacto (2 NeRF steps, 2 takeover steps, vMF guiding, the emitter the
model's forward) on a generated 10^2 scene: the relighting eval swaps the
emitter after the restore and leaves config.json as it was; every render
subcommand writes its files (`--video` an AVI), also with the learned
denoiser; the exporter restores the run's scene, or the template's for a
pretrain-only run. Against the JAX package: the rotate-light rotation and
the keyframe slerp. Every entry point needs a card unless told
`--device cpu`."""

import json
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.scripts import render as jrender
from nerf_emitter_tpu_torch.scripts import chamfer, endtask_run, exporter, gen_data, masked_psnr, render, train
from nerf_emitter_tpu_torch.scripts import eval as eval_cli
from nerf_emitter_tpu_torch.utils import exr

torch.set_num_threads(1)

TINY = ["--device", "cpu", "--train.num-rays-per-batch", "64", "--pipeline.spp", "2", "--pipeline.batch-size", "1",
        "--pipeline.takeover-image-size", "8", "--pipeline.sdf-init", "sphere", "--pipeline.distill-emitter", "false",
        "--steps-per-save", "1000", "--steps-per-eval-image", "1000", "--model.num-nerf-samples", "8",
        "--model.num-proposal-samples", "[16, 8]"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The event writer without TensorBoard (where TensorFlow is installed,
    its import takes ~10 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(scene dir, the run's config.json, a relighting envmap)."""
    root = tmp_path_factory.mktemp("cli")
    scene = gen_data.main(["--object", "sphere", "--n-views", "4", "--width", "10", "--height", "10", "--spp", "2",
                           "--out", str(root / "scene"), "--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        train.main(["sdf-nerfacto", "--datacfg.data", str(scene), "--experiment-name", "rl", "--output-dir",
                    str(root / "runs"), "--pipeline.takeover-step", "2", "--max-num-iterations", "4",
                    "--train.max-steps", "4", *TINY])
    img = exr.read_exr(scene / "env.exr")
    relit = root / "env_relit.exr"
    exr.write_exr(relit, np.roll(img[..., :3], img.shape[1] // 2, axis=1))
    return scene, root / "runs" / "rl" / "sdf-nerfacto" / "config.json", relit


def test_eval_relit_keeps_the_run_config(run, tmp_path):
    """A relighting eval restores the vMF-guided takeover, swaps the emitter
    for the envmap after the restore, writes the reference's keys, and
    never rewrites config.json."""
    scene, cfg, relit = run
    before = cfg.read_bytes()
    assert json.loads(before)["pipeline"]["guiding_type"] == "vmf"
    out = tmp_path / "relight.json"
    res = eval_cli.main(["--load-config", str(cfg), "--emitter-path", str(relit), "--test-data", str(scene),
                         "--spp", "2", "--output-path", str(out), "--device", "cpu"])
    assert json.loads(out.read_text()) == res
    assert set(res) == {"experiment", "method", "checkpoint_dir", "results"}
    assert (res["experiment"], res["method"]) == ("rl", "sdf-nerfacto")
    names = {"psnr", "ssim", "mape", "lpips_rf"}
    assert set(res["results"]) == names | {f"{k}_std" for k in names}
    assert np.isfinite(list(res["results"].values())).all()
    nvs = eval_cli.main(["--load-config", str(cfg), "--spp", "2", "--output-path", str(tmp_path / "nvs.json"),
                         "--device", "cpu"])
    assert nvs["results"]["psnr"] != res["results"]["psnr"]  # the NeRF lit it, not the envmap
    assert cfg.read_bytes() == before


SUBCOMMANDS = {
    "eval": ([], ["gt_0000.exr", "gt_0001.exr", "gt_0002.exr", "gt_0003.exr", "render_0000.exr", "render_0001.exr",
                  "render_0002.exr", "render_0003.exr"]),
    "rotate-light": (["--n-frames", "2", "--video"], ["frame_0000.exr", "frame_0001.exr", "rotate_light.avi"]),
    "envmap": (["--width", "8", "--height", "4"], ["envmap.exr"]),
    "camera-path": (["--n-frames", "2", "--video"], ["path.avi", "path_0000.exr", "path_0001.exr"]),
    "interpolate": (["--n-frames", "3"], ["interp_0000.exr", "interp_0001.exr", "interp_0002.exr"]),
    "spiral": (["--n-frames", "2", "--denoise"], ["spiral_0000.exr", "spiral_0001.exr"]),
    "stroke": ([], ["stroke.json"]),
}


@pytest.mark.parametrize("sub", list(SUBCOMMANDS))
def test_render_subcommand_writes_its_files(run, tmp_path, sub):
    _, cfg, _ = run
    extra, want = SUBCOMMANDS[sub]
    if sub == "stroke":
        (tmp_path / "in.json").write_text(json.dumps({"camera_index": 1, "pixels": [[5, 5], [5, 6], [2, 9]]}))
        extra = ["--stroke-path", str(tmp_path / "in.json")]
    dst = tmp_path / "out" / sub
    render.main([sub, "--load-config", str(cfg), "--output-path", str(dst), "--spp", "1", "--device", "cpu", *extra])
    got = sorted(p.name for p in (dst.parent.iterdir() if sub == "stroke" else dst.iterdir()))
    assert got == want
    if sub == "stroke":
        path = json.loads((dst.parent / "stroke.json").read_text())
        assert len(path["points"]) == 3 and np.isfinite(path["points"]).all()
    elif sub == "envmap":
        assert exr.read_exr(dst / "envmap.exr").shape == (4, 8, 3)
    else:
        frame = exr.read_exr(dst / next(w for w in want if w.endswith(".exr")))
        assert frame.shape == (10, 10, 3) and np.isfinite(frame).all()


def test_camera_path_file_keyframes(run, tmp_path):
    """A keyframe JSON of two poses: n_frames frames from the first key to
    the second, with the fields of view lerped."""
    _, cfg, _ = run
    c2w = [np.eye(4)[:3].tolist(), np.eye(4)[:3].tolist()]
    c2w[0][2][3], c2w[1][2][3] = 2.5, 2.0
    spec = {"keyframes": [{"c2w": c2w[0], "fov_deg": 30.0}, {"c2w": c2w[1], "fov_deg": 50.0}], "n_frames": 3}
    (tmp_path / "path.json").write_text(json.dumps(spec))
    render.main(["camera-path", "--load-config", str(cfg), "--output-path", str(tmp_path / "kf"), "--spp", "1",
                 "--camera-path-file", str(tmp_path / "path.json"), "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "kf").iterdir()) == ["path_0000.exr", "path_0001.exr", "path_0002.exr"]


@pytest.mark.parametrize("sub", ["eval", "rotate-light"])
def test_learned_denoiser_writes_its_files(run, tmp_path, monkeypatch, sub):
    """--denoise-mode learned fits the scene's denoiser on first use
    (DenoiserConfig cut to 20 steps of a narrow predictor for the CPU) and
    writes the subcommand's frames, finite."""
    from nerf_emitter_tpu_torch.pipelines import nerf_emitter as tne
    from nerf_emitter_tpu_torch.renderer.learned_denoise import DenoiserConfig

    monkeypatch.setattr(tne, "DenoiserConfig", lambda: DenoiserConfig(radius=1, hidden=8, depth=2, fit_steps=20))
    _, cfg, _ = run
    render.main([sub, "--load-config", str(cfg), "--output-path", str(tmp_path / "out"), "--spp", "1", "--n-frames",
                 "1", "--denoise", "--denoise-mode", "learned", "--device", "cpu"])
    want = SUBCOMMANDS["eval"][1] if sub == "eval" else ["frame_0000.exr"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == want
    frame = exr.read_exr(tmp_path / "out" / want[-1])
    assert frame.shape == (10, 10, 3) and np.isfinite(frame).all()


def test_rotate_light_rotation_matches_the_reference():
    """rotated_emitter turns the query's points about the centre and its
    directions as the reference's rotate-light closure does."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    for fi in range(3):
        angle = 2.0 * np.pi * fi / 3
        c, s = np.cos(angle), np.sin(angle)
        rot = jnp.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], jnp.float32)
        center = jnp.asarray([0.5, 0.5, 0.5])
        want = jnp.concatenate([(jnp.asarray(x) - center) @ rot.T + center, jnp.asarray(d) @ rot.T], -1)
        got = render.rotated_emitter(lambda a, b: torch.cat([a, b], -1), angle)(torch.from_numpy(x),
                                                                               torch.from_numpy(d))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_slerp_and_interpolation_match_the_reference():
    rng = np.random.default_rng(1)

    def rot(v):
        a = np.linalg.norm(v)
        k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]) / a
        return np.eye(3) + math.sin(a) * k + (1 - math.cos(a)) * k @ k

    src = np.stack([np.concatenate([rot(rng.normal(size=3)), rng.normal(size=(3, 1))], 1) for _ in range(3)])
    for t in (0.0, 0.3, 0.999):
        np.testing.assert_allclose(render._slerp(src[0, :, :3], src[1, :, :3], t),
                                   jrender._slerp(src[0, :, :3], src[1, :, :3], t), atol=1e-12)
    poses = render.interpolate_poses(src.astype(np.float32), 4)
    assert len(poses) == 4
    np.testing.assert_allclose(poses[0], src[0], atol=1e-6)
    with pytest.raises(ValueError, match="two cameras"):
        render.interpolate_poses(src[:1], 4)


def test_exporter_restores_the_run_scene(run, tmp_path):
    """The exporter's --load-config path restores the takeover's scene
    (template at the stored grid, no bind) and writes the mesh and the
    three volumes."""
    _, cfg, _ = run
    rec = exporter.main(["mi-marching-cubes", "--load-config", str(cfg), "--resolution", "20", "--output-dir",
                         str(tmp_path / "m"), "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == ["albedo.npy", "mesh.obj", "mesh.ply",
                                                                   "roughness.npy", "sdf.npy"]
    assert rec["faces"] > 100
    state = torch.load(cfg.parent / "checkpoints" / "4" / "state.pt", weights_only=True)
    np.testing.assert_array_equal(np.load(tmp_path / "m" / "sdf.npy"), state["sdf"]["scene"]["sdf"].numpy())


def test_exporter_pretrain_only_run_exports_the_template(run, tmp_path):
    scene, _, _ = run
    train.main(["sdf-nerfacto", "--datacfg.data", str(scene), "--experiment-name", "pre", "--output-dir",
                str(tmp_path / "runs"), "--pipeline.takeover-step", "100", "--max-num-iterations", "2",
                "--train.max-steps", "2", *TINY])
    exporter.main(["mi-marching-cubes", "--load-config", str(tmp_path / "runs/pre/sdf-nerfacto/config.json"),
                   "--resolution", "20", "--output-dir", str(tmp_path / "m"), "--device", "cpu"])
    sdf = np.load(tmp_path / "m" / "sdf.npy")
    from nerf_emitter_tpu_torch.renderer.grid3d import sphere_sdf_grid

    np.testing.assert_array_equal(sdf, sphere_sdf_grid(sdf.shape[0]).numpy())


@pytest.mark.parametrize("name", ["gen_data", "eval", "render", "exporter", "chamfer", "masked_psnr", "endtask_run"])
def test_entry_points_need_a_card(tmp_path, name):
    """Without --device cpu every tool runs on CUDA, and raises where there
    is none (never a quiet fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {
        "gen_data": (gen_data.main, ["--out", str(tmp_path)]),
        "eval": (eval_cli.main, ["--load-config", str(tmp_path / "c.json")]),
        "render": (render.main, ["eval", "--load-config", str(tmp_path / "c.json")]),
        "exporter": (exporter.main, ["mi-marching-cubes", "--sdf-volume", str(tmp_path / "s.npy")]),
        "chamfer": (chamfer.main, [str(tmp_path / "a.ply"), str(tmp_path / "b.ply")]),
        "masked_psnr": (masked_psnr.main, [str(tmp_path), str(tmp_path)]),
        "endtask_run": (endtask_run.main, ["--out", str(tmp_path)]),
    }[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        argv[0](argv[1])
    assert not any(tmp_path.iterdir())
