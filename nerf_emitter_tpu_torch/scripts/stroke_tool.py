"""Create stroke JSONs for the stroke->camera-path renderer.

A numpy copy of nerf_emitter_tpu/scripts/stroke_tool.py (the port imports
nothing of the JAX package); same CLI and outputs. PNGs are read with
utils/video.read_png (a GPU host need not have PIL); other formats, and
the `draw` canvas, import PIL and matplotlib when they run.

Re-design of the reference's `scripts/show_save_stroke.py` (:1-85, an
interactive matplotlib canvas that records mouse-drag pixels over a
training image and pickles them for StrokeToCameraXml). The render CLI
here consumes `{"camera_index": i, "pixels": [[y, x], ...]}` JSON
(scripts/render.py `stroke` subcommand), produced either by

- `draw`: the same interactive matplotlib flow (needs a display), or
- `from-mask`: headless — paint the stroke into an image (any nonzero /
  red-channel pixels), and the tool orders the pixels into a polyline by
  greedy nearest-neighbor chaining from the stroke's extremal point.

  python -m nerf_emitter_tpu_torch.scripts.stroke_tool from-mask \
      --mask stroke.png --camera-index 3 --output stroke.json [--step 4]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..utils.video import read_png


def order_stroke(pixels: np.ndarray, step: int = 1) -> np.ndarray:
    """(N, 2) unordered [y, x] -> polyline order by greedy NN chaining,
    starting from the point farthest from the centroid (an endpoint for
    any non-closed stroke). Subsamples every `step`-th chained pixel."""
    pts = pixels.astype(np.float64)
    start = int(np.argmax(np.linalg.norm(pts - pts.mean(0), axis=1)))
    n = len(pts)
    used = np.zeros(n, bool)
    order = [start]
    used[start] = True
    for _ in range(n - 1):
        d = np.linalg.norm(pts - pts[order[-1]], axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        if not np.isfinite(d[j]) or d[j] > 50.0:  # disconnected blob: stop
            break
        order.append(j)
        used[j] = True
    return pixels[np.asarray(order)][::step]


def read_image(path: Path) -> np.ndarray:
    """(H, W) or (H, W, C) uint8: PNGs without PIL, anything else through it."""
    if Path(path).suffix.lower() == ".png":
        img = read_png(path)
        return img[..., 0] if img.shape[-1] == 1 else img
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def cmd_from_mask(args):
    img = read_image(args.mask)
    if img.ndim == 3:
        mask = img[..., 0] > 127
    else:
        mask = img > 127
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        raise SystemExit("mask has no stroke pixels")
    stroke = order_stroke(np.stack([ys, xs], -1), args.step)
    out = {"camera_index": args.camera_index, "pixels": stroke.tolist()}
    Path(args.output).write_text(json.dumps(out))
    print(f"stroke: {len(stroke)} points -> {args.output}")


def cmd_draw(args):  # pragma: no cover - needs a display
    import matplotlib.pyplot as plt

    img = read_image(args.image)
    pixels: list[list[int]] = []
    fig, ax = plt.subplots()
    ax.imshow(img)
    ax.set_title("drag to draw; close the window to save")

    state = {"down": False}

    def on(event, down=None):
        if down is not None:
            state["down"] = down
        if state["down"] and event.xdata is not None:
            pixels.append([int(event.ydata), int(event.xdata)])
            ax.plot(event.xdata, event.ydata, "r.", markersize=2)
            fig.canvas.draw_idle()

    fig.canvas.mpl_connect("button_press_event", lambda e: on(e, True))
    fig.canvas.mpl_connect("button_release_event", lambda e: on(e, False))
    fig.canvas.mpl_connect("motion_notify_event", on)
    plt.show()
    if not pixels:
        raise SystemExit("no stroke drawn")
    out = {"camera_index": args.camera_index, "pixels": pixels[:: args.step]}
    Path(args.output).write_text(json.dumps(out))
    print(f"stroke: {len(pixels)} points -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stroke_tool")
    subs = ap.add_subparsers(dest="cmd", required=True)
    fm = subs.add_parser("from-mask")
    fm.add_argument("--mask", type=Path, required=True)
    fm.add_argument("--camera-index", type=int, default=0)
    fm.add_argument("--step", type=int, default=4)
    fm.add_argument("--output", type=Path, default=Path("stroke.json"))
    fm.set_defaults(fn=cmd_from_mask)
    dr = subs.add_parser("draw")
    dr.add_argument("--image", type=Path, required=True)
    dr.add_argument("--camera-index", type=int, default=0)
    dr.add_argument("--step", type=int, default=4)
    dr.add_argument("--output", type=Path, default=Path("stroke.json"))
    dr.set_defaults(fn=cmd_draw)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
