"""Turntable rotation calibration from ChArUco marker photos.

A numpy copy of nerf_emitter_tpu/scripts/calib_markers.py (the port imports nothing
of the JAX package); same CLI and outputs.

Re-design of the reference's `scripts/marker_to_metashape_xml.py`
(:38-336): it detects two ChArUco boards in calibration shots, groups
cameras by turntable position, and rewrites a Metashape XML so
photogrammetry solves all rotations in one frame. This framework's
real-capture dataparser consumes the result directly as a
`rotations` dict of 4x4 world transforms + per-frame `rotation` tags
(data/dataparsers/nerfstudio.py; reference
nerfstudio_dataparser.py:373-390), so the tool emits that JSON instead of
Metashape XML.

Input layout: a calibration directory with one subdirectory per turntable
position (`rot000/ rot045/ ...`, names become rotation tags), each holding
photos of the SAME ChArUco board taken by a static camera while the board
rides the table. For each position the board->camera pose is estimated
(solvePnP over detected corners) and averaged; the table transform of
position i relative to position 0 in board coordinates is
P_0^{-1} P_i ... lifted to the world frame of a reference camera pose when
`--camera-pose` (4x4 JSON) is given.

Requires OpenCV (cv2) — gated import, CPU-only.

  python -m nerf_emitter_tpu_torch.scripts.calib_markers \
      --calib-dir calib/ --intrinsics 1234 1234 960 540 \
      --squares 7 10 --square-length 0.04 --marker-length 0.02 \
      --output rotations.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def average_poses(mats: list[np.ndarray]) -> np.ndarray:
    """Chordal-mean rotation (SVD of the summed rotation blocks) + mean
    translation."""
    m = np.eye(4)
    rsum = np.sum([p[:3, :3] for p in mats], axis=0)
    u, _, vt = np.linalg.svd(rsum)
    r = u @ vt
    if np.linalg.det(r) < 0:
        u[:, -1] *= -1.0
        r = u @ vt
    m[:3, :3] = r
    m[:3, 3] = np.mean([p[:3, 3] for p in mats], axis=0)
    return m


def detect_board_pose(img_path, board, dictionary, K, dist):
    """Board->camera 4x4 from ChArUco corners, or None."""
    import cv2
    import cv2.aruco as aruco

    img = cv2.imread(str(img_path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        return None
    corners, ids, _ = aruco.detectMarkers(img, dictionary)
    if ids is None or len(ids) < 4:
        return None
    ok, ch_corners, ch_ids = aruco.interpolateCornersCharuco(
        corners, ids, img, board
    )
    if not ok or ch_ids is None or len(ch_ids) < 6:
        return None
    ok, rvec, tvec = aruco.estimatePoseCharucoBoard(
        ch_corners, ch_ids, board, K, dist, None, None
    )
    if not ok:
        return None
    m = np.eye(4)
    m[:3, :3] = cv2.Rodrigues(rvec)[0]
    m[:3, 3] = tvec.reshape(3)
    return m


def main(argv=None):
    ap = argparse.ArgumentParser(prog="calib_markers")
    ap.add_argument("--calib-dir", type=Path, required=True)
    ap.add_argument("--intrinsics", type=float, nargs=4, required=True,
                    metavar=("FX", "FY", "CX", "CY"))
    ap.add_argument("--dist", type=float, nargs="*", default=[0, 0, 0, 0, 0])
    ap.add_argument("--squares", type=int, nargs=2, default=[7, 10])
    ap.add_argument("--square-length", type=float, default=0.04)
    ap.add_argument("--marker-length", type=float, default=0.02)
    ap.add_argument("--start-id", type=int, default=200,
                    help="first aruco id on the board (reference uses 200)")
    ap.add_argument("--camera-pose", type=Path, default=None,
                    help="4x4 c2w JSON to lift transforms into world frame")
    ap.add_argument("--output", type=Path, default=Path("rotations.json"))
    args = ap.parse_args(argv)

    try:
        import cv2.aruco as aruco
    except ImportError as e:  # pragma: no cover
        raise SystemExit(f"calib_markers needs OpenCV with aruco: {e}")

    dictionary = aruco.getPredefinedDictionary(aruco.DICT_5X5_1000)
    nx, ny = args.squares
    board = aruco.CharucoBoard(
        (nx, ny),
        squareLength=args.square_length,
        markerLength=args.marker_length,
        dictionary=dictionary,
        ids=np.arange(args.start_id, args.start_id + nx * ny // 2, dtype=np.int32),
    )
    fx, fy, cx, cy = args.intrinsics
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    dist = np.asarray(args.dist, np.float64)

    groups = sorted(d for d in args.calib_dir.iterdir() if d.is_dir())
    if not groups:
        raise SystemExit(f"no rotation subdirectories in {args.calib_dir}")
    poses = {}
    for g in groups:
        mats = []
        for img in sorted(g.iterdir()):
            if img.suffix.lower() not in (".png", ".jpg", ".jpeg", ".tif"):
                continue
            m = detect_board_pose(img, board, dictionary, K, dist)
            if m is not None:
                mats.append(m)
        if not mats:
            print(f"warning: no board detected under {g.name}; skipping")
            continue
        poses[g.name] = average_poses(mats)
        print(f"{g.name}: {len(mats)} detections")

    if not poses:
        raise SystemExit("no rotations calibrated")
    ref_tag = sorted(poses)[0]
    p0 = poses[ref_tag]
    lift = np.eye(4)
    if args.camera_pose is not None:
        lift = np.asarray(json.loads(args.camera_pose.read_text()), np.float64)
    lift_inv = np.linalg.inv(lift)

    rotations = {}
    for tag, p in poses.items():
        # board motion in camera frame: P_i P_0^{-1}; conjugate into world
        t_cam = p @ np.linalg.inv(p0)
        rotations[tag] = (lift @ t_cam @ lift_inv).tolist()

    args.output.write_text(json.dumps({"rotations": rotations}, indent=2))
    print(f"wrote {len(rotations)} rotation transforms to {args.output}")


if __name__ == "__main__":
    main()
