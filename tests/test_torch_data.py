"""The port's data stack and image metrics against the JAX package: the
synthetic scene's files, both dataparsers, build_dataset, pixel-batch
sampling and train rays, the EXR codec across packages, the eval metrics
(psnr, ssim, mape and the perceptual distance) and the threefry PRNG that
makes the perceptual distance's kernels."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_emitter_tpu.data import datamanager as JD
from nerf_emitter_tpu.data import synthetic as JS
from nerf_emitter_tpu.data.dataparsers import instant_ngp as JI
from nerf_emitter_tpu.data.dataparsers import nerfstudio as JN
from nerf_emitter_tpu.engine.train_loop import eval_image_metrics as j_metrics
from nerf_emitter_tpu.utils import exr as jexr
from nerf_emitter_tpu.utils import perceptual as JP
from nerf_emitter_tpu_torch.data import datamanager as TD
from nerf_emitter_tpu_torch.data import synthetic as TS
from nerf_emitter_tpu_torch.data.dataparsers import instant_ngp as TI
from nerf_emitter_tpu_torch.data.dataparsers import nerfstudio as TN
from nerf_emitter_tpu_torch.engine.train_loop import eval_image_metrics as t_metrics
from nerf_emitter_tpu_torch.utils import exr as texr
from nerf_emitter_tpu_torch.utils import perceptual as TP

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic scene (10 views at 16^2) with turntable rotation tags
    (angles 0 and 90) and every third image given an alpha channel that
    masks its left half."""
    root = tmp_path_factory.mktemp("scene")
    TS.make_synthetic_dataset(root, n_views=10, width=16, height=16)
    meta = json.loads((root / "transforms.json").read_text())
    for i, fr in enumerate(meta["frames"]):
        fr["rotation"] = 90 * (i % 2)
        if i % 3 == 0:
            img = np.load(root / fr["file_path"])
            alpha = np.zeros((*img.shape[:2], 1), np.float32)
            alpha[:, img.shape[1] // 2:] = 1.0
            np.save(root / fr["file_path"], np.concatenate([img, alpha], -1))
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def test_synthetic_files_byte_equal(tmp_path):
    """The port's copy writes the JAX package's files byte for byte."""
    a, b = tmp_path / "jax", tmp_path / "port"
    JS.make_synthetic_dataset(a, n_views=5, width=20, height=12, seed=3)
    TS.make_synthetic_dataset(b, n_views=5, width=20, height=12, seed=3)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) == 6
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def _same_outputs(t, j):
    for f in ("image_filenames", "width", "height", "is_hdr", "mask_filenames"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "scene_aabb", "rotation_ids"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert set(t.metadata) == set(j.metadata)
    for k, v in j.metadata.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(t.metadata[k], v, err_msg=k)
        else:
            assert t.metadata[k] == v, k


@pytest.mark.parametrize("mode,split,down", [
    ("fraction", "train", 1), ("fraction", "val", 1), ("interval", "train", 2), ("interval", "test", 1),
    ("all", "mi_train", 1),
])
def test_instant_ngp_parser_matches_jax(scene, mode, split, down):
    """Every field and the metadata, exactly, per eval mode and split."""
    kw = dict(data=scene, eval_mode=mode, eval_interval=3, downscale_factor=down)
    _same_outputs(TI.parse_instant_ngp(TI.InstantNGPDataparserConfig(**kw), split),
                  JI.parse_instant_ngp(JI.InstantNGPDataparserConfig(**kw), split))


def test_instant_ngp_camera_angle_form(tmp_path, scene):
    """The Blender form (camera_angle_x, image size probed from the first
    .npy) parses to the same intrinsics in both packages."""
    meta = json.loads((scene / "transforms.json").read_text())
    meta = {"camera_angle_x": 0.5, "frames": meta["frames"]}
    for fr in meta["frames"]:
        fr["file_path"] = str(scene / fr["file_path"])
    (tmp_path / "transforms_train.json").write_text(json.dumps(meta))
    t = TI.parse_instant_ngp(TI.InstantNGPDataparserConfig(data=tmp_path), "train")
    _same_outputs(t, JI.parse_instant_ngp(JI.InstantNGPDataparserConfig(data=tmp_path), "train"))
    assert t.width == 16 and float(t.fx[0]) == pytest.approx(8.0 / np.tan(0.25))


@pytest.fixture(scope="module")
def ns_scene(scene, tmp_path_factory):
    """The synthetic views in the nerfstudio format: per-frame intrinsics
    overrides, mask paths, validity flags, rotation tags, calibrated
    rotations and a rotation box."""
    root = tmp_path_factory.mktemp("ns")
    meta = json.loads((scene / "transforms.json").read_text())
    frames = []
    for i, fr in enumerate(meta["frames"]):
        f = {"file_path": str(scene / fr["file_path"]), "transform_matrix": fr["transform_matrix"],
             "rotation": fr["rotation"], "valid": i != 4}
        if i % 2:
            f["fl_x"] = meta["fl_x"] * 1.1
            f["mask_path"] = f"masks/m_{i}.png"
        frames.append(f)
    ns = {k: meta[k] for k in ("fl_x", "fl_y", "cx", "cy", "w", "h")}
    ns |= {"frames": frames[::-1], "rotations": {"0": np.eye(4).tolist(), "90": np.eye(4).tolist()},
           "rotation_aabb": [[-0.3] * 3, [0.3] * 3]}
    (root / "transforms.json").write_text(json.dumps(ns))
    return root


@pytest.mark.parametrize("kw", [
    dict(), dict(filter_rotation=90), dict(shift_rotation=1, eval_mode="interval", eval_interval=3),
    dict(auto_scale_poses=False, scale_factor=0.5, orientation_method="none", center_method="none",
         downscale_factor=2),
], ids=["default", "filter_rotation", "shift_rotation", "no_auto"])
def test_nerfstudio_parser_matches_jax(ns_scene, kw):
    for split in ("train", "val"):
        _same_outputs(TN.parse_nerfstudio(TN.NerfstudioDataparserConfig(data=ns_scene, **kw), split),
                      JN.parse_nerfstudio(JN.NerfstudioDataparserConfig(data=ns_scene, **kw), split))


def test_build_dataset_matches_jax(scene):
    """Images, masks (from the alpha channels), cameras and rotation ids,
    exactly; on the CPU when asked, nowhere else by default without a card."""
    out = TI.parse_instant_ngp(TI.InstantNGPDataparserConfig(data=scene, eval_mode="all"), "train")
    for down in (1, 2):
        t = TD.build_dataset(out, down, device="cpu")
        j = JD.build_dataset(JI.parse_instant_ngp(JI.InstantNGPDataparserConfig(data=scene, eval_mode="all"),
                                                  "train"), down)
        assert t.images.device.type == "cpu" and t.is_hdr == j.is_hdr
        for a, b in ((t.images, j.images), (t.masks, j.masks), (t.rotation_ids, j.rotation_ids)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width", "height"):
            np.testing.assert_array_equal(np.asarray(getattr(t.cameras, f)), np.asarray(getattr(j.cameras, f)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TD.build_dataset(out)


def test_sample_pixel_batch(scene):
    """Shapes, dtypes and ranges; each target is its pixel's value; without
    masks the mask is ones; masked sampling's four rejection rounds put
    ~1 - 0.5^5 of a half-masked stack's draws inside the masks, against
    ~1/2 uniformly."""
    out = TI.parse_instant_ngp(TI.InstantNGPDataparserConfig(data=scene, eval_mode="all"), "train")
    ds = TD.build_dataset(out, device="cpu")
    g = torch.Generator().manual_seed(0)
    n = 4096
    cam, yx, rgb, mask = TD.sample_pixel_batch(g, ds.images, n)
    assert cam.shape == (n,) and yx.shape == (n, 2) and rgb.shape == (n, 3) and mask.shape == (n, 1)
    assert int(cam.min()) >= 0 and int(cam.max()) == 9 and int(yx.min()) >= 0 and int(yx.max()) == 15
    assert torch.equal(rgb, ds.images[cam, yx[:, 0], yx[:, 1]]) and bool((mask == 1).all())
    masks = torch.zeros_like(ds.masks)
    masks[..., 8:, :] = 1.0
    shares = {}
    for masked in (False, True):
        _, yx, _, m = TD.sample_pixel_batch(g, ds.images, n, masks=masks, masked_sampling=masked)
        assert torch.equal(m[:, 0], (yx[:, 1] >= 8).float())
        shares[masked] = float(m.mean())
    assert abs(shares[False] - 0.5) < 0.05 and shares[True] > 0.93, shares


def test_generate_train_rays_matches_jax(scene):
    """Without a generator the rays go through the pixel centres, as JAX's
    key=None (atol 1e-6); with one, jittered within the pixel."""
    out = TI.parse_instant_ngp(TI.InstantNGPDataparserConfig(data=scene), "train")
    t, j = TD.build_dataset(out, device="cpu"), JD.build_dataset(out)
    cam = np.array([0, 3, 5, 8]), np.array([[0, 0], [15, 15], [3, 9], [8, 2]])
    tr = TD.generate_train_rays(t.cameras, torch.from_numpy(cam[0]), torch.from_numpy(cam[1]), None,
                                near=0.05, far=6.0)
    jr = JD.generate_train_rays(j.cameras, jnp.asarray(cam[0]), jnp.asarray(cam[1]), None, near=0.05, far=6.0)
    for f in ("origins", "directions", "nears", "fars", "pixel_area"):
        np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)), rtol=1e-6, atol=1e-6)
    jit = TD.generate_train_rays(t.cameras, torch.from_numpy(cam[0]), torch.from_numpy(cam[1]),
                                 torch.Generator().manual_seed(0), near=0.05, far=6.0)
    step = 1.0 / float(t.cameras.fx[0])  # a pixel's width in the image plane at unit depth
    assert 0 < float((jit.directions - tr.directions).norm(dim=-1).max()) < step


@pytest.mark.parametrize("half,compress", [(True, True), (False, True), (True, False)],
                         ids=["half_zip", "float_zip", "half_none"])
def test_exr_across_packages(tmp_path, half, compress):
    """An EXR written by either package reads back the same in the other
    (exactly for FLOAT, to half precision for HALF), RGB and RGBA, 37 rows
    (a part-filled 16-line ZIP block)."""
    rng = np.random.default_rng(0)
    for c in (3, 4):
        img = rng.uniform(0, 8, size=(37, 23, c)).astype(np.float32)
        want = img.astype(np.float16).astype(np.float32) if half else img
        for write, read, tag in ((jexr.write_exr, texr.read_exr, "j2t"), (texr.write_exr, jexr.read_exr, "t2j")):
            p = tmp_path / f"{tag}_{c}.exr"
            write(p, img, half=half, compress=compress)
            np.testing.assert_array_equal(read(p), want)
            assert texr.read_exr_size(p) == (37, 23)


def test_load_image_matches_jax(tmp_path):
    """PNG (lazy PIL), .npy and .exr load to the same float32 arrays."""
    from PIL import Image

    rng = np.random.default_rng(1)
    img8 = rng.integers(0, 256, size=(9, 7, 3), dtype=np.uint8)
    Image.fromarray(img8).save(tmp_path / "a.png")
    np.save(tmp_path / "b.npy", rng.uniform(size=(9, 7, 3)).astype(np.float32))
    texr.write_exr(tmp_path / "c.exr", rng.uniform(size=(9, 7, 3)).astype(np.float32))
    for name in ("a.png", "b.npy", "c.exr"):
        for down in (1, 2):
            np.testing.assert_array_equal(TI.load_image(tmp_path / name, down), JI.load_image(tmp_path / name, down))


def _images(h, w, seed):
    """An HDR pair: a smooth gradient with a few bright pixels, and the same
    with noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    gt = np.stack([0.2 + 0.6 * xx, 0.3 + 0.4 * yy, 0.5 * xx * yy + 0.1], -1)
    gt[rng.integers(0, h, 5), rng.integers(0, w, 5)] = 4.0
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, None)
    return pred.astype(np.float32), gt.astype(np.float32)


# f32 on both sides; the convs' and means' summation orders differ: psnr,
# mape and the perceptual distance at rtol 1e-5 (measured within 1.5e-7,
# 4.7e-7 and 2.5e-7), ssim at atol 5e-5 (its variance terms cancel;
# measured 2.2e-5 on the HDR pair)
@pytest.mark.parametrize("h,w,hdr", [(40, 36, True), (24, 24, False), (9, 12, True)],
                         ids=["hdr", "ldr", "small"])
def test_eval_image_metrics_match_jax(h, w, hdr):
    """eval_image_metrics against JAX's: psnr, ssim, mape and lpips_rf; the
    9-row image shrinks ssim's window to 9 taps."""
    pred, gt = _images(h, w, seed=h)
    if not hdr:
        pred, gt = np.clip(pred, 0, 1), np.clip(gt, 0, 1)
    ref = {k: float(v) for k, v in j_metrics(jnp.asarray(pred), jnp.asarray(gt), is_hdr=hdr).items()}
    out = t_metrics(torch.from_numpy(pred), torch.from_numpy(gt), is_hdr=hdr)
    assert set(out) == set(ref) == {"psnr", "ssim", "mape", "lpips_rf"}
    np.testing.assert_allclose(out["psnr"], ref["psnr"], rtol=1e-5)
    np.testing.assert_allclose(out["mape"], ref["mape"], rtol=1e-5)
    np.testing.assert_allclose(out["ssim"], ref["ssim"], atol=5e-5)
    np.testing.assert_allclose(out["lpips_rf"], ref["lpips_rf"], rtol=1e-5)
    assert 0.0 < out["ssim"] < 1.0 and out["lpips_rf"] > 0.0


def test_threefry_matches_jax():
    """PRNGKey(1772), its splits and the 32-bit random bits equal JAX's bit
    for bit; normal() within 2 ulp of jax.random.normal; the metric's four
    kernels within 1e-6 of the JAX package's (measured 1.2e-7)."""
    key = jax.random.PRNGKey(1772)
    np.testing.assert_array_equal(TP.prng_key(1772), np.asarray(key))
    np.testing.assert_array_equal(TP.split(TP.prng_key(1772), 3), np.asarray(jax.random.split(key, 3)))
    k1 = jax.random.split(key)[1]
    np.testing.assert_array_equal(TP.random_bits(np.asarray(k1), (5, 7, 3)),
                                  np.asarray(jax.random.bits(k1, (5, 7, 3), jnp.uint32)))
    z, ref = TP.normal(np.asarray(k1), (4096,)), np.asarray(jax.random.normal(k1, (4096,)))
    np.testing.assert_allclose(z, ref, rtol=0.0, atol=2 * np.spacing(np.abs(ref).astype(np.float32)).max())
    for a, b in zip(TP._random_kernels(), JP._random_kernels()):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b), rtol=0.0, atol=1e-6)


def _lpips_pair(path, monkeypatch, pred, gt):
    """Both packages' lpips with NERF_EMITTER_LPIPS_WEIGHTS at `path`:
    ((value, name) of the port, (value, name) of JAX)."""
    monkeypatch.setenv("NERF_EMITTER_LPIPS_WEIGHTS", str(path))
    # the JAX module caches what it loaded (or that it found nothing)
    JP._loaded_kernels.cache_clear()
    JP._loaded_vgg.cache_clear()
    try:
        ref, ref_name = JP.lpips(jnp.asarray(pred), jnp.asarray(gt))
    finally:
        JP._loaded_kernels.cache_clear()
        JP._loaded_vgg.cache_clear()
    out, name = TP.lpips(torch.from_numpy(pred), torch.from_numpy(gt))
    return (float(out), name), (float(ref), ref_name)


def test_lpips_calibrated_pyramid_layout(tmp_path, monkeypatch):
    """NERF_EMITTER_LPIPS_WEIGHTS with the legacy pyramid layout (conv0-3,
    lin0-3) reports `lpips`, as JAX's does, within rtol 1e-4."""
    rng = np.random.default_rng(2)
    data, c_in = {}, 3
    for i, (c_out, k, _) in enumerate(TP._STAGES):
        data[f"conv{i}"] = rng.normal(size=(k, k, c_in, c_out)).astype(np.float32) / (k * np.sqrt(c_in))
        data[f"lin{i}"] = rng.uniform(-0.2, 1.0, size=c_out).astype(np.float32)
        c_in = c_out
    np.savez(tmp_path / "w.npz", **data)
    pred, gt = (np.clip(a, 0, 1) for a in _images(20, 20, seed=3))
    (out, name), (ref, ref_name) = _lpips_pair(tmp_path / "w.npz", monkeypatch, pred, gt)
    assert name == ref_name == "lpips"
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_lpips_vgg_layout(tmp_path, monkeypatch):
    """The VGG16-LPIPS layout (vgg_conv0-12, vgg_bias0-12, lin0-4), random
    weights at He scale as tests/test_tooling.py writes them: the input
    shift and scale, the pooling plan (36x28 pools to odd sizes and down to
    one column, where the floor of VALID pooling shows), the taps and the
    lin weights (some negative, clamped) against JAX's within rtol 1e-4;
    zero for the same image; the weights read once per path; a conv of the
    wrong shape raises."""
    rng = np.random.default_rng(4)
    data, c_in = {}, 3
    for i, c_out in enumerate(TP._VGG_CHANNELS):
        data[f"vgg_conv{i}"] = rng.normal(0, np.sqrt(2.0 / (9 * c_in)), (3, 3, c_in, c_out)).astype(np.float32)
        data[f"vgg_bias{i}"] = rng.normal(0, 0.01, (c_out,)).astype(np.float32)
        c_in = c_out
    for i, tap in enumerate(TP._VGG_TAPS):
        data[f"lin{i}"] = rng.uniform(-0.2, 1.0, size=TP._VGG_CHANNELS[tap]).astype(np.float32)
    np.savez(tmp_path / "vgg.npz", **data)
    pred, gt = (np.clip(a, 0, 1) for a in _images(36, 28, seed=5))
    (out, name), (ref, ref_name) = _lpips_pair(tmp_path / "vgg.npz", monkeypatch, pred, gt)
    assert name == ref_name == "lpips" and out > 0.0
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    assert float(TP.lpips(torch.from_numpy(gt), torch.from_numpy(gt))[0]) == 0.0
    hits = TP._load_weights.cache_info().hits
    TP.lpips(torch.from_numpy(pred), torch.from_numpy(gt))
    assert TP._load_weights.cache_info().hits == hits + 1
    data["vgg_conv5"] = data["vgg_conv5"][..., :100]
    np.savez(tmp_path / "bad.npz", **data)
    monkeypatch.setenv("NERF_EMITTER_LPIPS_WEIGHTS", str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="vgg_conv5"):
        TP.lpips(torch.from_numpy(pred), torch.from_numpy(gt))


_MATH_CASES = {
    "linear_to_srgb": lambda m, x, y: m.linear_to_srgb(x),
    "srgb_to_linear": lambda m, x, y: m.srgb_to_linear(x),
    "expected_sin": lambda m, x, y: m.expected_sin(4.0 * x - 2.0, y),
    "masked_reduction": lambda m, x, y: m.masked_reduction(x, y[:, :1] > 0.5),
    "masked_reduction_empty": lambda m, x, y: m.masked_reduction(x, y[:, :1] > 2.0),
}


@pytest.mark.parametrize("case", sorted(_MATH_CASES))
def test_math_helpers_match_jax(case):
    """utils/math.py's colour transforms (inputs past both ends of [0, 1],
    both branches of the sRGB curves), expected_sin and masked_reduction
    (a broadcast mask; an empty one gives 0) against the JAX package's, f32
    on both sides: rtol 1e-6, atol 1e-7."""
    from nerf_emitter_tpu.utils import math as jm
    from nerf_emitter_tpu_torch.utils import math as tm

    rng = np.random.default_rng(11)
    x = np.concatenate([rng.uniform(-0.2, 1.2, (60, 3)), np.full((4, 3), 0.002)]).astype(np.float32)
    y = rng.uniform(0.0, 1.5, (64, 3)).astype(np.float32)
    ref = np.asarray(_MATH_CASES[case](jm, jnp.asarray(x), jnp.asarray(y)))
    out = _MATH_CASES[case](tm, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
