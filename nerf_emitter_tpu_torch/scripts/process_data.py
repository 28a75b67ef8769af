"""Capture processing: Metashape XML (incl. turntable) -> dataset.

A numpy copy of nerf_emitter_tpu/scripts/process_data.py (the port imports
nothing of the JAX package); same subcommands, flags and outputs. PIL is
imported only where an image is resized (`--num-downscales` > 0) or its
size is read (realitycapture).

Scoped re-design of the reference's `scripts/process_data.py` +
`process_data/metashape_utils.py` (3041 LoC): the converters the paper's
real-capture flow actually uses, with no external binaries.

- `metashape`: one Metashape camera XML -> transforms.json (chunk
  transform + per-camera poses + sensor intrinsics; CV->GL axis flip;
  optional extra affine, e.g. inv_inner_box_transform from
  inner_outer_box.py; PIL image downscale pyramid).
- `rotated-metashape`: the paper's turntable capture
  (ProcessRotatedMetashape, process_data.py:318-480): per-rotation XML
  pairs (solved-before-rotation, solved-after) -> merged transforms.json
  with per-frame `rotation` tags, calibrated `rotations` matrices
  (before @ inv(after) per rotation) and `rotation_aabb`.
- `images`: a poses JSON ({"frames": [{"file_path", "transform_matrix"}],
  intrinsics...}) -> transforms.json + downscales.
- `polycam`: a Polycam LiDAR export (keyframes/{images,cameras}[,depth])
  -> transforms.json with per-frame intrinsics, blur-score filtering and
  border cropping (reference process_data/polycam_utils.py:28-118).
- `record3d`: a Record3D capture (EXR|RGBD dir + metadata JSON of
  scalar-last quaternion poses and the K matrix) -> transforms.json
  (reference process_data/record3d_utils.py:28-93).
- `realitycapture`: a RealityCapture CSV registration (name, position,
  heading/pitch/roll, f in 35mm-equiv, distortion) -> transforms.json
  (reference process_data/realitycapture_utils.py:29-127).

COLMAP-based conversion needs the colmap binary (not in this image); the
subcommand exists but exits with instructions when colmap is missing.
"""

from __future__ import annotations

import argparse
import json
import shutil
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

# OpenCV/Metashape camera (+z forward, +y down) -> OpenGL (-z forward)
_CV2GL = np.diag([1.0, -1.0, -1.0, 1.0])


def _chunk_transform(root) -> np.ndarray:
    """4x4 chunk/component transform (rotation + translation + scale)."""
    m = np.eye(4)
    for tag in ("components/component/transform", "transform"):
        t = root.find(f"chunk/{tag}")
        if t is None:
            continue
        r = t.find("rotation")
        tr = t.find("translation")
        s = t.find("scale")
        if r is not None:
            m[:3, :3] = np.fromstring(r.text, sep=" ").reshape(3, 3)
        if s is not None:
            m[:3, :3] *= float(s.text)
        if tr is not None:
            m[:3, 3] = np.fromstring(tr.text, sep=" ")
        break
    return m


def _sensors(root) -> dict:
    out = {}
    for sensor in root.findall("chunk/sensors/sensor"):
        sid = sensor.get("id")
        calib = sensor.find("calibration")
        if calib is None:
            continue
        res = calib.find("resolution")
        w = float(res.get("width"))
        h = float(res.get("height"))
        get = lambda k, d=0.0: float(calib.find(k).text) if calib.find(k) is not None else d
        f = get("f")
        out[sid] = {
            "w": int(w), "h": int(h), "fl_x": f, "fl_y": f,
            "cx": w / 2.0 + get("cx"), "cy": h / 2.0 + get("cy"),
            "k1": get("k1"), "k2": get("k2"), "k3": get("k3"),
            "p1": get("p1"), "p2": get("p2"),
        }
    return out


def metashape_xml_to_frames(xml_path: Path, extra_transform: np.ndarray | None = None):
    """Parse a Metashape camera XML -> (frames list, shared intrinsics).

    Mirrors process_data/metashape_utils.metashape_to_json:36-170: world
    pose = chunk_transform @ camera_transform, then the CV->GL flip;
    `extra_transform` (e.g. inv inner-box) is applied on the left.
    """
    root = ET.parse(xml_path).getroot()
    chunk = _chunk_transform(root)
    sensors = _sensors(root)
    extra = np.eye(4) if extra_transform is None else extra_transform

    frames = []
    intrinsics = None
    for cam in root.findall("chunk/cameras/camera") + root.findall(
        "chunk/cameras/group/camera"
    ):
        t = cam.find("transform")
        if t is None or cam.get("enabled") in ("false", "0"):
            continue
        label = cam.get("label")
        sid = cam.get("sensor_id")
        if sid in sensors and intrinsics is None:
            intrinsics = sensors[sid]
        m = np.fromstring(t.text, sep=" ").reshape(4, 4)
        c2w = extra @ chunk @ m @ _CV2GL
        frames.append({"file_path": label, "transform_matrix": c2w.tolist()})
    return frames, (intrinsics or {})


def _downscale_images(src_dir: Path, out_dir: Path, num_downscales: int, prefix=""):
    images = sorted(
        p for p in src_dir.iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg", ".exr", ".tif")
    )
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    names = []
    for p in images:
        name = f"{prefix}{p.name}"
        shutil.copy2(p, out_dir / "images" / name)
        names.append(name)
        if p.suffix.lower() == ".exr" or num_downscales < 1:
            continue  # HDR pyramid handled by the dataparser at load time
        from PIL import Image

        img = Image.open(p)
        for d in range(1, num_downscales + 1):
            dd = out_dir / f"images_{2**d}"
            dd.mkdir(exist_ok=True)
            img.resize((img.width // 2**d, img.height // 2**d)).save(dd / name)
    return names


def cmd_metashape(args):
    frames, intr = metashape_xml_to_frames(
        args.xml,
        np.loadtxt(args.extra_transform) if args.extra_transform else None,
    )
    names = []
    if args.data is not None:
        names = _downscale_images(args.data, args.output_dir, args.num_downscales)
        by_stem = {Path(n).stem: n for n in names}
        # Metashape labels may carry the image extension; match by stem.
        matched = [
            {**fr, "file_path": f"images/{by_stem[Path(fr['file_path']).stem]}"}
            for fr in frames
            if Path(fr["file_path"]).stem in by_stem
        ]
        if frames and not matched:
            raise SystemExit(
                f"no camera labels matched any image in {args.data} "
                f"(e.g. label {frames[0]['file_path']!r} vs images "
                f"{names[:3]}...)"
            )
        if len(matched) < len(frames):
            print(f"warning: {len(frames) - len(matched)} labeled cameras "
                  "had no matching image and were dropped")
        frames = matched
    args.output_dir.mkdir(parents=True, exist_ok=True)
    meta = {**intr, "camera_model": "OPENCV", "frames": frames}
    (args.output_dir / "transforms.json").write_text(json.dumps(meta, indent=2))
    print(f"{len(frames)} frames -> {args.output_dir / 'transforms.json'}")


def cmd_rotated_metashape(args):
    """Merge per-rotation solves and calibrate turntable transforms."""
    inv_inner = np.loadtxt(args.inner_outer_path / "inv_inner_box_transform.txt")
    outer_aabb = np.loadtxt(args.inner_outer_path / "outer_box_aabb.txt")
    res = None
    rotations = {}
    for name in args.rotation_names:
        frames, intr = metashape_xml_to_frames(
            Path(str(args.xml).format(name)), inv_inner
        )
        frames_rot, _ = metashape_xml_to_frames(
            Path(str(args.rotation_xml).format(name)), inv_inner
        )
        for fr in frames:
            fr["rotation"] = name
        if res is None:
            res = {**intr, "camera_model": "OPENCV", "frames": frames}
        else:
            res["frames"].extend(frames)
        # the SAME physical camera solved before/after the turntable moved:
        # the world-frame rotation transform is before @ inv(after)
        # (reference process_data.py:461-468)
        if frames[0]["file_path"] != frames_rot[0]["file_path"]:
            raise SystemExit(f"rotation {name}: camera label mismatch")
        before = np.asarray(frames[0]["transform_matrix"])
        after = np.asarray(frames_rot[0]["transform_matrix"])
        rotations[name] = (before @ np.linalg.inv(after)).tolist()
    res["rotations"] = rotations
    res["rotation_aabb"] = outer_aabb.tolist()
    args.output_dir.mkdir(parents=True, exist_ok=True)
    (args.output_dir / "transforms.json").write_text(json.dumps(res, indent=2))
    print(
        f"{len(res['frames'])} frames, {len(rotations)} rotations -> "
        f"{args.output_dir / 'transforms.json'}"
    )


def cmd_images(args):
    meta = json.loads(args.poses.read_text())
    names = _downscale_images(args.data, args.output_dir, args.num_downscales)
    by_name = {n: n for n in names}
    frames = [
        {**fr, "file_path": f"images/{by_name.get(Path(fr['file_path']).name, fr['file_path'])}"}
        for fr in meta["frames"]
    ]
    out = {**{k: v for k, v in meta.items() if k != "frames"}, "frames": frames}
    args.output_dir.mkdir(parents=True, exist_ok=True)
    (args.output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    print(f"{len(frames)} frames -> {args.output_dir / 'transforms.json'}")


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Scalar-LAST (x, y, z, w) unit quaternions (N, 4) -> (N, 3, 3)."""
    x, y, z, w = (q[:, i] for i in range(4))
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                      2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                      2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                      1 - 2 * (x * x + y * y)], -1),
        ],
        axis=1,
    )


def cmd_polycam(args):
    """Polycam export: keyframes/cameras/*.json hold per-frame intrinsics,
    a blur score, and a row-major 3x4 pose whose WORLD axes are permuted
    (x, y, z) -> (z, x, y) relative to the GL convention the dataparsers
    use (reference polycam_utils.py:73-79)."""
    kf = args.data / "keyframes"
    cam_dir = kf / "cameras"
    img_dir = kf / ("corrected_images" if (kf / "corrected_images").is_dir()
                    else "images")
    depth_dir = kf / "depth"
    crop = args.crop_border_pixels
    names = _downscale_images(img_dir, args.output_dir, args.num_downscales)
    frames, skipped = [], 0
    for name in names:
        meta_path = cam_dir / f"{Path(name).stem}.json"
        if not meta_path.exists():
            skipped += 1
            continue
        m = json.loads(meta_path.read_text())
        if m.get("blur_score", np.inf) < args.min_blur_score:
            skipped += 1
            continue
        pose = np.eye(4)
        for r in range(3):
            for c in range(4):
                pose[r, c] = m[f"t_{r}{c}"]
        pose = pose[[2, 0, 1, 3], :]  # world-axis permutation (see above)
        frame = {
            "fl_x": m["fx"], "fl_y": m["fy"],
            "cx": m["cx"] - crop, "cy": m["cy"] - crop,
            "w": m["width"] - 2 * crop, "h": m["height"] - 2 * crop,
            "file_path": f"images/{name}",
            "transform_matrix": pose.tolist(),
        }
        d = depth_dir / f"{Path(name).stem}.png"
        if d.exists():
            frame["depth_file_path"] = str(d)
        frames.append(frame)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    out = {"camera_model": "OPENCV", "frames": frames}
    (args.output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    print(f"{len(frames)} frames ({skipped} skipped) -> "
          f"{args.output_dir / 'transforms.json'}")


def cmd_record3d(args):
    """Record3D: metadata JSON carries scalar-last quaternion+translation
    poses (N, 7) and the column-major K matrix (reference
    record3d_utils.py:42-77)."""
    meta = json.loads(args.metadata.read_text())
    poses = np.asarray(meta["poses"], np.float64)  # (N, [qx qy qz qw tx ty tz])
    c2w = np.concatenate(
        [_quat_to_mat(poses[:, :4]), poses[:, 4:, None]], axis=-1
    )
    names = _downscale_images(args.data, args.output_dir, args.num_downscales)
    if args.max_dataset_size and len(names) > args.max_dataset_size:
        idx = np.round(
            np.linspace(0, len(names) - 1, args.max_dataset_size)
        ).astype(int)
        names = [names[i] for i in idx]
    else:
        idx = np.arange(len(names))
    if c2w.shape[0] < len(names):
        raise SystemExit(
            f"{c2w.shape[0]} poses for {len(names)} images — metadata and"
            f" image dir disagree"
        )
    frames = [
        {
            "file_path": f"images/{n}",
            "transform_matrix": np.vstack(
                [c2w[i], [0.0, 0.0, 0.0, 1.0]]
            ).tolist(),
        }
        for n, i in zip(names, idx)
    ]
    K = np.asarray(meta["K"], np.float64).reshape(3, 3).T  # column-major
    h, w = meta["h"], meta["w"]
    out = {
        "fl_x": K[0, 0], "fl_y": K[0, 0],
        # principal point from the metadata K has known indexing issues
        # upstream (record3d_utils.py:75-77); center like the reference
        "cx": w / 2.0, "cy": h / 2.0, "w": w, "h": h,
        "camera_model": "OPENCV", "frames": frames,
    }
    args.output_dir.mkdir(parents=True, exist_ok=True)
    (args.output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    print(f"{len(frames)} frames -> {args.output_dir / 'transforms.json'}")


def _euler_rotation(heading_deg, pitch_deg, roll_deg) -> np.ndarray:
    """RealityCapture's yaw(z) @ pitch(x) @ roll(y) with negated heading
    (reference realitycapture_utils.py:90,113-127)."""
    yw, pt, rl = (np.deg2rad(a) for a in (-heading_deg, pitch_deg, roll_deg))
    cz, sz = np.cos(yw), np.sin(yw)
    cx, sx = np.cos(pt), np.sin(pt)
    cy, sy = np.cos(rl), np.sin(rl)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return rz @ rx @ ry


def cmd_realitycapture(args):
    """RealityCapture CSV registration -> transforms.json. Focal length is
    35mm-equivalent (scale by max(w, h)/36); principal point offsets are
    in the same film units from center."""
    import csv

    from PIL import Image

    names = _downscale_images(args.data, args.output_dir, args.num_downscales)
    by_stem = {Path(n).stem: n for n in names}
    with open(args.csv) as f:
        rows = list(csv.DictReader(f))
    frames, missing = [], 0
    for row in rows:
        stem = Path(row["#name"]).stem
        if stem not in by_stem:
            missing += 1
            continue
        name = by_stem[stem]
        with Image.open(args.output_dir / "images" / name) as img:
            w, h = img.size
        scale = max(w, h) / 36.0
        c2w = np.eye(4)
        c2w[:3, :3] = _euler_rotation(
            float(row["heading"]), float(row["pitch"]), float(row["roll"])
        )
        c2w[:3, 3] = [float(row["x"]), float(row["y"]), float(row["alt"])]
        frames.append({
            "file_path": f"images/{name}",
            "w": w, "h": h,
            "fl_x": float(row["f"]) * scale, "fl_y": float(row["f"]) * scale,
            "cx": float(row["px"]) / 36.0 + w / 2.0,
            "cy": float(row["py"]) / 36.0 + h / 2.0,
            "k1": float(row.get("k1", 0)), "k2": float(row.get("k2", 0)),
            "transform_matrix": c2w.tolist(),
        })
    if missing:
        print(f"warning: {missing} CSV rows had no matching image")
    args.output_dir.mkdir(parents=True, exist_ok=True)
    out = {"camera_model": "OPENCV", "frames": frames}
    (args.output_dir / "transforms.json").write_text(json.dumps(out, indent=2))
    print(f"{len(frames)} frames -> {args.output_dir / 'transforms.json'}")


def cmd_colmap(args):
    if shutil.which("colmap") is None:
        raise SystemExit(
            "colmap binary not found. Install COLMAP for structure-from-motion"
            " pose estimation, or use the 'metashape' / 'images' converters"
            " with externally solved poses."
        )
    raise SystemExit("colmap conversion: run colmap, then use 'images' with the exported poses")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="process_data")
    subs = ap.add_subparsers(dest="cmd", required=True)

    ms = subs.add_parser("metashape")
    ms.add_argument("--xml", type=Path, required=True)
    ms.add_argument("--data", type=Path, default=None, help="image dir")
    ms.add_argument("--extra-transform", type=Path, default=None,
                    help="4x4 txt applied on the left (e.g. inv inner box)")
    ms.add_argument("--num-downscales", type=int, default=3)
    ms.add_argument("--output-dir", type=Path, required=True)
    ms.set_defaults(fn=cmd_metashape)

    rm = subs.add_parser("rotated-metashape")
    rm.add_argument("--xml", type=str, required=True,
                    help="template with {} for rotation name")
    rm.add_argument("--rotation-xml", type=str, required=True)
    rm.add_argument("--rotation-names", nargs="+", default=["0", "90", "180", "270"])
    rm.add_argument("--inner-outer-path", type=Path, required=True)
    rm.add_argument("--output-dir", type=Path, required=True)
    rm.set_defaults(fn=cmd_rotated_metashape)

    im = subs.add_parser("images")
    im.add_argument("--data", type=Path, required=True)
    im.add_argument("--poses", type=Path, required=True)
    im.add_argument("--num-downscales", type=int, default=3)
    im.add_argument("--output-dir", type=Path, required=True)
    im.set_defaults(fn=cmd_images)

    pc = subs.add_parser("polycam")
    pc.add_argument("--data", type=Path, required=True,
                    help="Polycam export root (contains keyframes/)")
    pc.add_argument("--min-blur-score", type=float, default=25.0)
    pc.add_argument("--crop-border-pixels", type=int, default=15)
    pc.add_argument("--num-downscales", type=int, default=3)
    pc.add_argument("--output-dir", type=Path, required=True)
    pc.set_defaults(fn=cmd_polycam)

    r3 = subs.add_parser("record3d")
    r3.add_argument("--data", type=Path, required=True, help="image dir")
    r3.add_argument("--metadata", type=Path, required=True,
                    help="Record3D metadata JSON")
    r3.add_argument("--max-dataset-size", type=int, default=0,
                    help="evenly subsample to at most N frames (0 = all)")
    r3.add_argument("--num-downscales", type=int, default=3)
    r3.add_argument("--output-dir", type=Path, required=True)
    r3.set_defaults(fn=cmd_record3d)

    rc = subs.add_parser("realitycapture")
    rc.add_argument("--data", type=Path, required=True, help="image dir")
    rc.add_argument("--csv", type=Path, required=True,
                    help="RealityCapture registration CSV")
    rc.add_argument("--num-downscales", type=int, default=3)
    rc.add_argument("--output-dir", type=Path, required=True)
    rc.set_defaults(fn=cmd_realitycapture)

    cm = subs.add_parser("colmap")
    cm.set_defaults(fn=cmd_colmap)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
