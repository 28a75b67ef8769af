"""The port's tools that the JAX suite tests (tests/test_tooling.py:212-333
and :463-601), each case on the port's copy with its output held equal to
the JAX script's on the same input: transform_scene, inner_outer_box, the
stroke tool (a PIL-written mask read without PIL), the texture atlas and
bake (the port's grid_sample on the CPU, texels within 1e-6 of JAX's, the
PNG within one 8-bit step), calib_markers' pose average and the five
process_data converters (transforms.json equal, copied images
byte-equal). Then the leaf helpers against JAX (coords, the encodings'
widths, the colliders and composites), profiler.trace, and read_png on
PNGs with every row filter (PIL's and each of the five written here)."""

import json
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_emitter_tpu.scripts import calib_markers as jcm
from nerf_emitter_tpu.scripts import inner_outer_box as jiob
from nerf_emitter_tpu.scripts import process_data as jpd
from nerf_emitter_tpu.scripts import stroke_tool as jst
from nerf_emitter_tpu.scripts import texture as jtex
from nerf_emitter_tpu.scripts import transform_scene as jts
from nerf_emitter_tpu_torch.scripts import calib_markers as tcm
from nerf_emitter_tpu_torch.scripts import inner_outer_box as tiob
from nerf_emitter_tpu_torch.scripts import process_data as tpd
from nerf_emitter_tpu_torch.scripts import stroke_tool as tst
from nerf_emitter_tpu_torch.scripts import texture as ttex
from nerf_emitter_tpu_torch.scripts import transform_scene as tts
from nerf_emitter_tpu_torch.utils.video import read_png
from test_tooling import _write_metashape_xml

torch.set_num_threads(1)


def _both(tmp_path, name, run):
    """run(module, out_dir) for the JAX script and the port's; returns the
    two output dirs."""
    outs = []
    for tag, mod in (("j", name[0]), ("t", name[1])):
        out = tmp_path / tag
        run(mod, out)
        outs.append(out)
    return outs


def _same_tree(a, b):
    """Two output dirs hold the same files, byte for byte."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# ---- transform_scene, inner_outer_box, stroke_tool, calib_markers


def test_transform_scene_tool(tmp_path):
    """The JAX suite's case on the port: poses left-multiplied, scale
    stripped with --exclude-scale, calibration rotations conjugated; each
    output file equal to the JAX script's."""
    c2w = np.eye(4)
    c2w[:3, 3] = [1.0, 2.0, 3.0]
    inp = tmp_path / "transforms.json"
    inp.write_text(json.dumps({"frames": [{"file_path": "a.png", "transform_matrix": c2w.tolist()}]}))
    rot = np.eye(4)
    rot[:2, :2] = [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]
    calib = tmp_path / "calib.json"
    calib.write_text(json.dumps({"rotations": {"0": np.eye(4).tolist(), "45": rot.tolist()}}))
    for flags in (["--scale", "2.0", "--translate", "0", "0", "1"], ["--scale", "2.0", "--exclude-scale"],
                  ["--matrix", *map(str, (np.eye(3, 4) + np.arange(12).reshape(3, 4) / 17.0).ravel()),
                   "--rotations-json", str(calib)]):
        outs = {}
        for tag, mod in (("j", jts), ("t", tts)):
            outs[tag] = tmp_path / f"{tag}.json"
            mod.main(["--input", str(inp), "--output", str(outs[tag]), *flags])
            if "--rotations-json" in flags:
                outs[tag + "c"] = calib.with_suffix(".transformed.json").read_bytes()
        assert outs["j"].read_bytes() == outs["t"].read_bytes()
        if "--rotations-json" in flags:
            assert outs["jc"] == outs["tc"]
    m = np.asarray(json.loads((tmp_path / "t.json").read_text())["frames"][0]["transform_matrix"])
    assert m.shape == (4, 4)
    T = np.eye(4)
    T[:3, 3] = [5.0, 0.0, 0.0]
    conj = tts.conjugate_rotations(json.loads(calib.read_text()), T)
    rel = np.linalg.inv(np.asarray(conj["rotations"]["0"])) @ np.asarray(conj["rotations"]["45"])
    np.testing.assert_allclose(rel[:3, :3], rot[:3, :3], atol=1e-12)
    out = tmp_path / "s.json"
    tts.main(["--input", str(inp), "--output", str(out), "--scale", "2.0", "--translate", "0", "0", "1"])
    m = np.asarray(json.loads(out.read_text())["frames"][0]["transform_matrix"])
    np.testing.assert_allclose(m[:3, 3], [2.0, 4.0, 7.0])
    np.testing.assert_allclose(m[:3, :3], 2.0 * np.eye(3))


def test_inner_outer_box_tool(tmp_path):
    inner, outer = np.diag([2.0, 2.0, 2.0, 1.0]), np.diag([4.0, 4.0, 4.0, 1.0])
    aabb, inv_inner = tiob.outer_in_inner(inner, outer)
    np.testing.assert_allclose(aabb, [[-2, -2, -2], [2, 2, 2]])
    np.testing.assert_allclose(inv_inner @ inner, np.eye(4), atol=1e-12)
    rng = np.random.default_rng(0)
    inner = np.eye(4)
    inner[:3] = rng.normal(size=(3, 4))
    (tmp_path / "i.json").write_text(json.dumps(inner.tolist()))
    (tmp_path / "o.json").write_text(json.dumps(outer.tolist()))
    j, t = _both(tmp_path, (jiob, tiob), lambda mod, out: mod.main(
        ["--inner", str(tmp_path / "i.json"), "--outer", str(tmp_path / "o.json"), "--output-dir", str(out)]))
    _same_tree(j, t)


def test_stroke_order_and_from_mask(tmp_path):
    """An L-shaped stroke painted by PIL: the port reads the mask without
    PIL, chains it as a polyline from one end to the other, and writes the
    JAX script's JSON."""
    mask = np.zeros((32, 32), np.uint8)
    mask[5, 5:20] = 255
    mask[5:25, 19] = 255
    Image.fromarray(mask).save(tmp_path / "m.png")
    Image.fromarray(np.stack([mask, mask // 3, mask // 5], -1)).save(tmp_path / "rgb.png")
    for src in ("m.png", "rgb.png"):
        for tag, mod in (("j", jst), ("t", tst)):
            mod.main(["from-mask", "--mask", str(tmp_path / src), "--camera-index", "2", "--step", "1",
                      "--output", str(tmp_path / f"{tag}.json")])
        assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    stroke = json.loads((tmp_path / "t.json").read_text())
    assert stroke["camera_index"] == 2
    px = np.asarray(stroke["pixels"])
    assert np.linalg.norm(np.diff(px, axis=0), axis=1).max() < 2.0
    assert {tuple(px[0]), tuple(px[-1])} == {(5, 5), (24, 19)}


def test_calib_markers_average_poses():
    th = 0.2
    r = np.eye(4)
    r[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    np.testing.assert_allclose(tcm.average_poses([r, r, r]), r, atol=1e-12)
    r2 = np.eye(4)
    r2[:2, :2] = [[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]]
    np.testing.assert_allclose(tcm.average_poses([r, r2])[:3, :3], np.eye(3), atol=1e-12)
    rng = np.random.default_rng(1)
    mats = []
    for _ in range(4):
        m = np.eye(4)
        m[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        m[:3, 3] = rng.normal(size=3)
        mats.append(m)
    np.testing.assert_array_equal(tcm.average_poses(mats), jcm.average_poses(mats))


# ---- texture


def _quad():
    verts = np.array([[0.1, 0.1, 0.5], [0.9, 0.1, 0.5], [0.9, 0.9, 0.5], [0.1, 0.9, 0.5]])
    return verts, np.array([[0, 1, 2], [0, 2, 3]])


def test_texture_atlas_bake(tmp_path):
    """The JAX suite's case on the port (texels at each face's centroid
    equal its surface point within 0.15), the atlas equal to JAX's, the
    OBJ written and read back."""
    verts, faces = _quad()
    uvs, tex_size = ttex.grid_atlas_uvs(len(faces), px_per_tri=6)
    juvs, jsize = jtex.grid_atlas_uvs(len(faces), px_per_tri=6)
    np.testing.assert_array_equal(uvs, juvs)
    assert tex_size == jsize and uvs.shape == (2, 3, 2) and (uvs >= 0).all() and (uvs <= 1).all()
    tex = ttex.bake_texture(verts, faces, uvs, tex_size, lambda p: p.astype(np.float32), 6)
    for f in range(2):
        c_uv = uvs[f].mean(0) * tex_size
        np.testing.assert_allclose(tex[int(c_uv[1]), int(c_uv[0])], verts[faces[f]].mean(0), atol=0.15)
    ttex.write_textured_obj(tmp_path, "mesh", verts, faces, uvs)
    txt = (tmp_path / "mesh.obj").read_text()
    assert "vt " in txt and "mtllib mesh.mtl" in txt
    v2, f2 = ttex.read_obj(tmp_path / "mesh.obj")
    np.testing.assert_allclose(v2, verts)
    np.testing.assert_array_equal(f2, faces)


def test_texture_cli_matches_jax(tmp_path):
    """The CLI on a 40-face mesh and random 9^3 volumes: the port's
    grid_sample sampler against JAX's (texels within 1e-6), both PNGs
    within one 8-bit step of JAX's (a texel on a rounding boundary), the
    OBJ and MTL equal."""
    from nerf_emitter_tpu.renderer.grid3d import grid_sample as jgrid_sample

    rng = np.random.default_rng(2)
    verts = rng.uniform(0.05, 0.95, (30, 3))
    faces = rng.integers(0, 30, (40, 3))
    with open(tmp_path / "in.obj", "w") as f:
        f.writelines([f"v {a} {b} {c}\n" for a, b, c in verts] + [f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces])
    albedo = rng.uniform(0, 1, (9, 9, 9, 3)).astype(np.float32)
    rough = rng.uniform(0, 1, (9, 9, 9, 1)).astype(np.float32)
    np.save(tmp_path / "albedo.npy", albedo)
    np.save(tmp_path / "rough.npy", rough)
    pts = rng.uniform(0, 1, (500, 3))
    np.testing.assert_allclose(ttex.volume_sampler(albedo, "cpu")(pts),
                               np.asarray(jgrid_sample(jnp.asarray(albedo), jnp.asarray(pts))), rtol=0, atol=1e-6)
    argv = ["--input-mesh", str(tmp_path / "in.obj"), "--albedo-volume", str(tmp_path / "albedo.npy"),
            "--roughness-volume", str(tmp_path / "rough.npy"), "--px-per-uv-triangle", "4"]
    jtex.main([*argv, "--output-dir", str(tmp_path / "j")])
    ttex.main([*argv, "--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    for name in ("mesh.obj", "mesh.mtl"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()
    for name in ("mesh_albedo.png", "mesh_roughness.png"):
        want = np.asarray(Image.open(tmp_path / "j" / name)).astype(int)
        got = read_png(tmp_path / "t" / name).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1


# ---- process_data


def _metashape(tmp_path):
    cam = np.eye(4)
    cam[:3, 3] = [0.0, 0.0, 5.0]
    _write_metashape_xml(tmp_path / "c.xml", cam)
    img = tmp_path / "imgs"
    img.mkdir()
    Image.new("RGB", (16, 12), (10, 20, 30)).save(img / "cam0.png")
    return ["metashape", "--xml", str(tmp_path / "c.xml"), "--data", str(img), "--num-downscales", "1"]


def _rotated(tmp_path):
    np.savetxt(tmp_path / "inv_inner_box_transform.txt", np.eye(4))
    np.savetxt(tmp_path / "outer_box_aabb.txt", np.array([[-2.0] * 3, [2.0] * 3]))
    th = np.pi / 2
    rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    cam = np.eye(4)
    cam[:3, 3] = [3.0, 0.0, 0.0]
    after = np.eye(4)
    after[:3, :3], after[:3, 3] = rz.T, rz.T @ cam[:3, 3]
    for name in ("0", "90"):
        _write_metashape_xml(tmp_path / f"solve_{name}.xml", cam, label=f"c{name}")
        _write_metashape_xml(tmp_path / f"rot_{name}.xml", cam if name == "0" else after, label=f"c{name}")
    return ["rotated-metashape", "--xml", str(tmp_path / "solve_{}.xml"), "--rotation-xml",
            str(tmp_path / "rot_{}.xml"), "--rotation-names", "0", "90", "--inner-outer-path", str(tmp_path)]


def _polycam(tmp_path):
    kf = tmp_path / "keyframes"
    (kf / "images").mkdir(parents=True)
    (kf / "cameras").mkdir()
    pose = np.eye(4)
    pose[:3, 3] = [1.0, 2.0, 3.0]
    for i, blur in enumerate([100.0, 1.0]):  # the second frame is too blurry
        Image.new("RGB", (64, 48)).save(kf / "images" / f"f{i}.jpg")
        meta = {"fx": 500.0, "fy": 500.0, "cx": 32.0, "cy": 24.0, "width": 64, "height": 48, "blur_score": blur}
        meta |= {f"t_{r}{c}": pose[r, c] for r in range(3) for c in range(4)}
        (kf / "cameras" / f"f{i}.json").write_text(json.dumps(meta))
    return ["polycam", "--data", str(tmp_path), "--min-blur-score", "25", "--crop-border-pixels", "2",
            "--num-downscales", "1"]


def _record3d(tmp_path):
    img = tmp_path / "rgb"
    img.mkdir()
    for i in range(3):
        Image.new("RGB", (32, 24)).save(img / f"{i}.jpg")
    q = [0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)]
    K = np.array([[400.0, 0, 0], [0, 400.0, 0], [16.0, 12.0, 1.0]])
    (tmp_path / "metadata.json").write_text(json.dumps(
        {"poses": [q + [float(i), 0.0, 1.0] for i in range(3)], "K": K.flatten().tolist(), "w": 32, "h": 24}))
    return ["record3d", "--data", str(img), "--metadata", str(tmp_path / "metadata.json"), "--max-dataset-size", "2",
            "--num-downscales", "1"]


def _realitycapture(tmp_path):
    img = tmp_path / "imgs"
    img.mkdir()
    Image.new("RGB", (72, 36)).save(img / "shot.png")
    (tmp_path / "reg.csv").write_text("#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2\n"
                                      "shot.png,1.0,2.0,3.0,10,20,30,36.0,0.0,0.0,0,0,0,0,0,0\n")
    return ["realitycapture", "--data", str(img), "--csv", str(tmp_path / "reg.csv"), "--num-downscales", "1"]


def _check_metashape(meta):
    fr = meta["frames"][0]
    assert meta["fl_x"] == 500.0 and meta["w"] == 640 and meta["cx"] == 322.0 and meta["cy"] == 237.0
    assert fr["file_path"] == "images/cam0.png"
    m = np.asarray(fr["transform_matrix"])
    np.testing.assert_allclose(m[:3, 3], [1.0, 0.0, 10.0])
    np.testing.assert_allclose(m[:3, :3], np.diag([2.0, -2.0, -2.0]))


def _check_rotated(meta):
    assert [f["rotation"] for f in meta["frames"]] == ["0", "90"]
    np.testing.assert_allclose(np.asarray(meta["rotations"]["0"]), np.eye(4), atol=1e-10)
    assert abs(np.linalg.det(np.asarray(meta["rotations"]["90"])[:3, :3]) - 1.0) < 1e-6
    assert meta["rotation_aabb"] == [[-2.0] * 3, [2.0] * 3]


def _check_polycam(meta):
    assert len(meta["frames"]) == 1
    fr = meta["frames"][0]
    assert fr["w"] == 60 and fr["cx"] == 30.0
    np.testing.assert_allclose(np.asarray(fr["transform_matrix"])[:3, 3], [3.0, 1.0, 2.0])


def _check_record3d(meta):
    assert meta["fl_x"] == 400.0 and meta["w"] == 32 and len(meta["frames"]) == 2
    m = np.asarray(meta["frames"][1]["transform_matrix"])
    np.testing.assert_allclose(m[:3, 3], [2.0, 0.0, 1.0])
    np.testing.assert_allclose(m[:3, :3], [[0, -1, 0], [1, 0, 0], [0, 0, 1.0]], atol=1e-12)


def _check_realitycapture(meta):
    fr = meta["frames"][0]
    assert fr["fl_x"] == 72.0 and fr["cx"] == 36.0 and fr["cy"] == 18.0
    np.testing.assert_allclose(np.asarray(fr["transform_matrix"])[:3, 3], [1.0, 2.0, 3.0])


PROCESS = {"metashape": (_metashape, _check_metashape), "rotated-metashape": (_rotated, _check_rotated),
           "polycam": (_polycam, _check_polycam), "record3d": (_record3d, _check_record3d),
           "realitycapture": (_realitycapture, _check_realitycapture)}


@pytest.mark.parametrize("sub", list(PROCESS))
def test_process_data_converters(tmp_path, sub):
    """Each converter of tests/test_tooling.py on the port: its checks, and
    the output tree (transforms.json, copied and downscaled images) equal
    to the JAX script's byte for byte."""
    make, check = PROCESS[sub]
    argv = make(tmp_path)
    j, t = _both(tmp_path, (jpd, tpd), lambda mod, out: mod.main([*argv, "--output-dir", str(out)]))
    _same_tree(j, t)
    check(json.loads((t / "transforms.json").read_text()))


def test_process_data_colmap_exits():
    """Without a colmap binary the subcommand exits with the reference's
    instructions."""
    import shutil

    if shutil.which("colmap") is not None:
        pytest.skip("a colmap binary is installed")
    for mod in (jpd, tpd):
        with pytest.raises(SystemExit, match="colmap binary not found"):
            mod.main(["colmap"])


def test_metashape_xml_to_frames_matches_jax(tmp_path):
    cam = np.eye(4)
    cam[:3, :3] = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))[0]
    cam[:3, 3] = [0.5, -1.0, 5.0]
    _write_metashape_xml(tmp_path / "c.xml", cam, rot3=np.diag([1.0, -1.0, -1.0]))
    extra = np.diag([0.5, 0.5, 0.5, 1.0])
    assert tpd.metashape_xml_to_frames(tmp_path / "c.xml", extra) == jpd.metashape_xml_to_frames(tmp_path / "c.xml",
                                                                                                 extra)


# ---- leaf helpers, profiler.trace, read_png


def test_coords_roundtrip():
    """tests/test_core_math.py's cases on the port, and each matrix equal to
    JAX's."""
    from nerf_emitter_tpu.utils import coords as jc
    from nerf_emitter_tpu_torch.utils import coords as tc

    pts = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 3)).astype(np.float32))
    s = 1.5
    torch.testing.assert_close(tc.unit_to_world(tc.world_to_unit(pts, s), s), pts, rtol=0, atol=1e-5)
    m = tc.world_to_unit_mat(s)
    torch.testing.assert_close(tc.apply_homogeneous(m, pts), tc.world_to_unit(pts, s), rtol=0, atol=1e-5)
    torch.testing.assert_close(tc.mi2gl_left() @ tc.gl2mi_left(), torch.eye(4), rtol=0, atol=1e-6)
    for name in ("mi2gl_left", "gl2mi_left"):
        np.testing.assert_array_equal(getattr(tc, name)().numpy(), np.asarray(getattr(jc, name)()))
    for name in ("world_to_unit_mat", "unit_to_world_mat"):
        np.testing.assert_array_equal(getattr(tc, name)(s).numpy(), np.asarray(getattr(jc, name)(s)))
    mat = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 4)).astype(np.float32))
    for name in ("apply_homogeneous", "apply_rotation"):
        np.testing.assert_allclose(getattr(tc, name)(mat, pts).numpy(),
                                   np.asarray(getattr(jc, name)(jnp.asarray(mat.numpy()), jnp.asarray(pts.numpy()))),
                                   rtol=1e-6, atol=1e-6)


def test_nerf_encode_dims():
    from nerf_emitter_tpu.fields import encodings as je
    from nerf_emitter_tpu_torch.fields import encodings as te

    out = te.nerf_encode(torch.zeros((8, 3)), num_frequencies=4)
    assert out.shape == (8, 3 * (2 * 4 + 1)) == (8, te.nerf_encode_dim(3, 4))
    for args in ((3, 4, True), (3, 10, False), (2, 1, True)):
        assert te.nerf_encode_dim(*args) == je.nerf_encode_dim(*args)
    assert [te.sh_dim(d) for d in range(1, 6)] == [je.sh_dim(d) for d in range(1, 6)]


def test_colliders_and_composites_match_jax():
    from nerf_emitter_tpu.cameras.rays import RayBundle as JRays
    from nerf_emitter_tpu.ops import colliders as jcol
    from nerf_emitter_tpu.ops import rendering as jr
    from nerf_emitter_tpu_torch.cameras.rays import RayBundle as TRays
    from nerf_emitter_tpu_torch.ops import colliders as tcol
    from nerf_emitter_tpu_torch.ops import rendering as tr

    rng = np.random.default_rng(4)
    n = 64
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = dict(origins=rng.uniform(-2, 2, (n, 3)).astype(np.float32), directions=d,
             pixel_area=np.full((n, 1), 1e-4, np.float32), nears=np.zeros((n, 1), np.float32),
             fars=np.full((n, 1), 5.0, np.float32), camera_indices=np.zeros((n, 1), np.int32))
    jrays = JRays(**{k: jnp.asarray(v) for k, v in r.items()})
    trays = TRays(**{k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                     for k, v in r.items()})
    aabb = np.array([[-0.5, -0.4, -0.3], [0.6, 0.5, 0.4]], np.float32)
    cases = [(jcol.near_far_collider(jrays, 0.1, 3.0), tcol.near_far_collider(trays, 0.1, 3.0)),
             (jcol.aabb_intersect_collider(jrays, jnp.asarray(aabb)),
              tcol.aabb_intersect_collider(trays, torch.from_numpy(aabb)))]
    hit = np.asarray(cases[1][0].fars) - np.asarray(cases[1][0].nears) > 1e-5
    assert 0 < hit.sum() < n  # both branches
    for j, t in cases:
        for k in ("nears", "fars"):
            np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(j, k)), rtol=1e-6, atol=1e-6)
    w = rng.uniform(0, 0.2, (n, 12)).astype(np.float32)
    vals = rng.normal(size=(n, 12, 5)).astype(np.float32)
    np.testing.assert_allclose(tr.composite_normals(torch.from_numpy(vals[..., :3]), torch.from_numpy(w)).numpy(),
                               np.asarray(jr.composite_normals(jnp.asarray(vals[..., :3]), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tr.composite_generic(torch.from_numpy(vals), torch.from_numpy(w)).numpy(),
                               np.asarray(jr.composite_generic(jnp.asarray(vals), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)


def test_profiler_trace_writes_a_trace(tmp_path):
    from nerf_emitter_tpu_torch.utils import profiler

    with profiler.trace(tmp_path / "off", enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "off").exists()
    with profiler.trace(tmp_path / "tr"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _png(path, img: np.ndarray, kind: int):
    """An 8-bit PNG of img (H, W, C) with every row filtered by `kind`."""
    h, w, c = img.shape
    prior = np.zeros(w * c, np.int64)
    rows = []
    for row in img.reshape(h, w * c).astype(np.int64):
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        p = left + prior - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        pred = [0, left, prior, (left + prior) // 2, paeth][kind]
        rows.append(np.concatenate([[kind], (row - pred) % 256]).astype(np.uint8))
        prior = row

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_read_png_reads_filtered_rows(tmp_path, mode):
    """A PIL-written PNG (PIL filters its rows adaptively) and a PNG of the
    same image with every row under each of the five filters read back bit
    for bit."""
    c = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    yy, xx = np.mgrid[0:23, 0:19]
    img = ((yy * 7 + xx * 3)[..., None] + np.random.default_rng(5).integers(0, 9, (23, 19, c))).astype(np.uint8)
    Image.fromarray(img[..., 0] if c == 1 else img, mode).save(tmp_path / "pil.png")
    np.testing.assert_array_equal(read_png(tmp_path / "pil.png"), img)
    for kind in range(5):
        _png(tmp_path / f"f{kind}.png", img, kind)
        np.testing.assert_array_equal(read_png(tmp_path / f"f{kind}.png"), img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"f{kind}.png")).reshape(img.shape), img)
