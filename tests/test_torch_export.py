"""The port's mesh export, geometry and image tools against the JAX
package on the same numpy inputs: marching cubes (identical), its
upsampled evaluation and the vertex texturing (the interpolant on the
device), mesh files, chamfer and the largest component, masked PSNR, the
exporter CLI on a raw volume; and the port's own stdlib PNG and
uncompressed-AVI writers read back."""

import json
import struct

import numpy as np
import pytest
import torch

from nerf_emitter_tpu.exporter import marching_cubes as jmc
from nerf_emitter_tpu.renderer.grid3d import composite_sdf_grid as j_composite
from nerf_emitter_tpu.renderer.grid3d import sphere_sdf_grid as j_sphere
from nerf_emitter_tpu.scripts import chamfer as jch
from nerf_emitter_tpu.scripts import exporter as jexp
from nerf_emitter_tpu.scripts import masked_psnr as jmp
from nerf_emitter_tpu_torch.exporter import marching_cubes as tmc
from nerf_emitter_tpu_torch.scripts import chamfer as tch
from nerf_emitter_tpu_torch.scripts import exporter as texp
from nerf_emitter_tpu_torch.scripts import masked_psnr as tmp_
from nerf_emitter_tpu_torch.utils import video

torch.set_num_threads(1)


def _grid(kind: str, res: int) -> np.ndarray:
    return np.asarray(j_sphere(res, radius=0.3) if kind == "sphere" else j_composite(res))


@pytest.mark.parametrize("kind", ["sphere", "composite"])
def test_marching_cubes_is_the_references(kind):
    """The tables and the extraction are the reference's: the same mesh to
    the bit."""
    sdf = _grid(kind, 33)
    (vj, fj), (vt, ft) = jmc.marching_cubes(sdf), tmc.marching_cubes(sdf)
    assert len(ft) > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)


@pytest.mark.parametrize("kind", ["sphere", "composite"])
def test_upsampled_marching_cubes_matches_jax(kind):
    """The interpolant at 48^3 evaluated by the port's grid_sample: the same
    faces, vertices within 1e-5."""
    sdf = _grid(kind, 17)
    vj, fj = jmc.upsampled_marching_cubes(sdf, 48)
    vt, ft = tmc.upsampled_marching_cubes(sdf, 48, device="cpu")
    assert len(fj) > 100
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, atol=1e-5, rtol=0)


def test_sample_vertex_attributes_matches_jax():
    rng = np.random.default_rng(0)
    verts = rng.uniform(-0.05, 1.05, (500, 3)).astype(np.float32)
    albedo = rng.uniform(0, 1, (5, 6, 7, 3)).astype(np.float32)
    rough = rng.uniform(0, 1, (4, 4, 4, 1)).astype(np.float32)
    j = jmc.sample_vertex_attributes(verts, albedo, rough)
    t = tmc.sample_vertex_attributes(verts, albedo, rough, device="cpu")
    assert set(t) == set(j) == {"albedo", "roughness"}
    for k in j:
        np.testing.assert_allclose(t[k], np.asarray(j[k]), atol=1e-6, rtol=1e-6)
    assert set(tmc.sample_vertex_attributes(verts, albedo, device="cpu")) == {"albedo"}


@pytest.mark.parametrize("name", ["m.obj", "m.ply"])
@pytest.mark.parametrize("colored", [False, True])
def test_mesh_files_match_jax(tmp_path, name, colored):
    """The writers' files are byte-equal to the reference's, and both
    readers read them back to the same mesh."""
    v, f = tmc.marching_cubes(_grid("sphere", 17))
    colors = np.random.default_rng(1).uniform(0, 1, v.shape).astype(np.float32) if colored else None
    writers = {"m.obj": (tmc.write_obj, jmc.write_obj), "m.ply": (tmc.write_ply, jmc.write_ply)}[name]
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    writers[0](tmp_path / "t" / name, v, f, colors)
    writers[1](tmp_path / "j" / name, v, f, colors)
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    vt, ft = tmc.read_ply_or_obj(tmp_path / "t" / name)
    vj, fj = jmc.read_ply_or_obj(tmp_path / "t" / name)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(vt, v)
    np.testing.assert_array_equal(ft, f)


@pytest.mark.parametrize("shift", [0.0, 0.1])
def test_chamfer_distance_matches_jax(shift):
    """The tiled device minimum against the reference's JAX map (within 1e-6
    relative), on surface samples drawn by the same numpy generator."""
    v, f = tmc.marching_cubes(_grid("sphere", 17))
    a = tch.sample_mesh_points(v, f, 700, seed=0)
    np.testing.assert_array_equal(a, jch.sample_mesh_points(v, f, 700, seed=0))
    b = tch.sample_mesh_points(v, f, 900, seed=1) + shift
    want = jch.chamfer_distance(a, b)
    got = tch.chamfer_distance(a, b, chunk=256, device="cpu")
    assert got == pytest.approx(want, rel=1e-6)
    assert tch.chamfer_distance(b, b, device="cpu") == 0.0


def test_largest_component_matches_jax():
    """Two spheres' meshes: the larger one is kept, as the reference keeps it."""
    v1, f1 = tmc.marching_cubes(np.asarray(j_sphere(25, radius=0.25, center=(0.3, 0.5, 0.5))))
    v2, f2 = tmc.marching_cubes(np.asarray(j_sphere(25, radius=0.12, center=(0.8, 0.5, 0.5))))
    v = np.concatenate([v2, v1])
    f = np.concatenate([f2, f1 + len(v2)])
    (vj, fj), (vt, ft) = jch.largest_component(v, f), tch.largest_component(v, f)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert len(vt) == len(v1) and len(ft) == len(f1)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_psnr_matches_jax(masked):
    rng = np.random.default_rng(2)
    gt = rng.uniform(0, 2, (12, 9, 3)).astype(np.float32)
    pred = (gt + rng.normal(0, 0.1, gt.shape)).astype(np.float32)
    mask = (rng.uniform(0, 1, (12, 9, 1)) > 0.4).astype(np.float32) if masked else None
    assert tmp_.masked_psnr(pred, gt, mask, device="cpu") == pytest.approx(jmp.masked_psnr(pred, gt, mask),
                                                                         abs=1e-4)


def test_masked_psnr_cli_reads_the_port_pngs_and_exrs(tmp_path, capsys):
    """The CLI over PNG directories (utils/video.write_png) and EXR ones
    (with the prediction's alpha as the mask) gives the function's PSNR,
    and the JAX package's CLI's on the same files."""
    from nerf_emitter_tpu_torch.utils import exr

    rng = np.random.default_rng(3)
    for d in ("p", "g", "pe", "ge"):
        (tmp_path / d).mkdir()
    want_png, want_exr = [], []
    for i in range(2):
        g = rng.integers(0, 256, (6, 5, 3)).astype(np.uint8)
        p = np.clip(g.astype(int) + rng.integers(-9, 10, g.shape), 0, 255).astype(np.uint8)
        video.write_png(tmp_path / "p" / f"{i}.png", p)
        video.write_png(tmp_path / "g" / f"{i}.png", g)
        want_png.append(tmp_.masked_psnr(p / 255.0, g / 255.0, None, device="cpu"))
        ge = rng.uniform(0, 2, (6, 5, 3)).astype(np.float32)
        pe = np.concatenate([ge * 1.1, (rng.uniform(0, 1, (6, 5, 1)) > 0.5)], -1).astype(np.float32)
        exr.write_exr(tmp_path / "pe" / f"{i}.exr", pe, half=False)
        exr.write_exr(tmp_path / "ge" / f"{i}.exr", ge, half=False)
        want_exr.append(tmp_.masked_psnr(pe, ge, pe[..., 3:], device="cpu"))
    out = tmp_.main([str(tmp_path / "p"), str(tmp_path / "g"), "--pattern", "*.png", "--device", "cpu"])
    np.testing.assert_allclose(out["per_image"], want_png, rtol=1e-6)
    capsys.readouterr()
    jmp.main([str(tmp_path / "p"), str(tmp_path / "g"), "--pattern", "*.png"])  # PIL reads the PNGs there
    np.testing.assert_allclose(out["per_image"], json.loads(capsys.readouterr().out)["per_image"], atol=1e-4)
    out = tmp_.main([str(tmp_path / "pe"), str(tmp_path / "ge"), "--device", "cpu"])
    np.testing.assert_allclose(out["per_image"], want_exr, rtol=1e-6)
    assert out["psnr"] == pytest.approx(np.mean(want_exr))
    capsys.readouterr()
    jmp.main([str(tmp_path / "pe"), str(tmp_path / "ge")])
    np.testing.assert_allclose(out["per_image"], json.loads(capsys.readouterr().out)["per_image"], atol=1e-4)


def test_exporter_sdf_volume_matches_jax(tmp_path):
    """`mi-marching-cubes --sdf-volume --albedo-volume`: the port's files
    against the reference's: the same faces, vertices and vertex colours
    within 1e-5, the volumes equal."""
    sdf = _grid("composite", 17)
    albedo = np.random.default_rng(4).uniform(0, 1, (4, 4, 4, 3)).astype(np.float32)
    np.save(tmp_path / "sdf.npy", sdf)
    np.save(tmp_path / "albedo.npy", albedo)
    common = ["mi-marching-cubes", "--sdf-volume", str(tmp_path / "sdf.npy"), "--albedo-volume",
              str(tmp_path / "albedo.npy"), "--resolution", "24"]
    jexp.main(common + ["--output-dir", str(tmp_path / "j")])
    rec = texp.main(common + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    for name in ("mesh.obj", "mesh.ply"):
        vt, ft = tmc.read_ply_or_obj(tmp_path / "t" / name)
        vj, fj = tmc.read_ply_or_obj(tmp_path / "j" / name)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_allclose(vt, vj, atol=1e-5, rtol=0)
    rows = [[ln.split()[1:] for ln in (tmp_path / d / "mesh.obj").read_text().splitlines() if ln.startswith("v ")]
            for d in ("t", "j")]
    np.testing.assert_allclose(np.asarray(rows[0], float), np.asarray(rows[1], float), atol=1e-5)
    assert rec["faces"] == len(ft)
    for name in ("sdf.npy", "albedo.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name))
    assert not (tmp_path / "t" / "roughness.npy").exists()


def test_exporter_requires_a_source():
    with pytest.raises(SystemExit):
        texp.main(["mi-marching-cubes", "--device", "cpu"])


def _avi_frames(data: bytes):
    """The RIFF structure's main header fields and the '00db' frames of an
    uncompressed AVI, decoded (bottom-up BGR rows padded to 4 bytes)."""
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI "
    assert struct.unpack("<I", data[4:8])[0] == len(data) - 8
    i = data.index(b"avih")
    usec, _, _, flags, n, _, streams, _, w, h = struct.unpack("<10I", data[i + 8:i + 48])
    i = data.index(b"strf")
    assert struct.unpack("<IiiHHI", data[i + 8:i + 28]) == (40, w, h, 1, 24, 0)
    i = data.index(b"movi")
    frames = []
    while len(frames) < n:
        i = data.index(b"00db", i)
        size = struct.unpack("<I", data[i + 4:i + 8])[0]
        rows = np.frombuffer(data[i + 8:i + 8 + size], np.uint8).reshape(h, -1)[:, :3 * w]
        frames.append(rows.reshape(h, w, 3)[::-1, :, ::-1])
        i += 8 + size
    i = data.index(b"idx1")
    assert struct.unpack("<I", data[i + 4:i + 8])[0] == 16 * n
    return dict(usec=usec, flags=flags, n=n, streams=streams, w=w, h=h), frames


@pytest.mark.parametrize("width", [48, 7])
def test_avi_reads_back(tmp_path, width):
    """Every frame of the uncompressed AVI reads back to the bit (a width
    of 7 pads each row); float frames are clipped to [0, 1]."""
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (6, width, 3)).astype(np.uint8) for _ in range(3)]
    frames.append(np.full((6, width, 3), 1.7, np.float32))
    p = video.write_avi(tmp_path / "out.avi", frames, fps=10)
    hdr, back = _avi_frames(p.read_bytes())
    assert hdr == dict(usec=100_000, flags=0x10, n=4, streams=1, w=width, h=6)
    for a, b in zip(back, frames[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back[3], np.full((6, width, 3), 255, np.uint8))
    with pytest.raises(ValueError):
        video.write_avi(tmp_path / "x.avi", [])
    with pytest.raises(ValueError):
        video.write_avi(tmp_path / "x.avi", [frames[0], frames[0][:, :3]])


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip(tmp_path, channels):
    """write_png's files read back by read_png and by PIL; a PNG whose rows
    are 'sub'-filtered (write_png never filters) reads back as PIL reads
    it, and one with an unknown row filter raises."""
    import zlib

    from PIL import Image

    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (9, 11, channels)).astype(np.uint8)
    video.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(video.read_png(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")).reshape(img.shape), img)
    raw = np.concatenate([np.ones((9, 1), np.uint8), img.reshape(9, -1)], axis=1).tobytes()  # 'sub' rows
    data = (tmp_path / "a.png").read_bytes()
    ihdr = data[8:8 + 25]
    (tmp_path / "f.png").write_bytes(data[:8] + ihdr + video._png_chunk(b"IDAT", zlib.compress(raw))
                                     + video._png_chunk(b"IEND", b""))
    np.testing.assert_array_equal(video.read_png(tmp_path / "f.png"),
                                  np.asarray(Image.open(tmp_path / "f.png")).reshape(img.shape))
    (tmp_path / "u.png").write_bytes(data[:8] + ihdr + video._png_chunk(b"IDAT", zlib.compress(raw.replace(
        b"\x01", b"\x05", 1))) + video._png_chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unknown PNG row filter"):
        video.read_png(tmp_path / "u.png")
