"""A method run through the train CLI with its stages timed:

    python -m nerf_emitter_tpu_torch.scripts.method_run [--views 64] [--res 256] [--seed 0] [--out DIR] \
        -- sdf-nerfacto [train flags]

writes the synthetic scene (data/synthetic.py: `--views` views at `--res`^2,
from `--seed`) unless the train flags give `--datacfg.data`, runs
scripts/train.main on it (into `--out`, by default a temporary directory)
with the pipeline's and the trainer's stages wrapped by
`profiling.Stages`, and prints one JSON line: each stage's calls (seconds,
the port's kernel launches), the pretraining ms per step, the takeover ms
per step at each render size, the trainer's rows of events.jsonl (train
metrics every 10 steps, eval metrics), the last SDF grid's interior share
and its value at the cameras, the peak device memory, and the card's name
and power limit. The run is on the card unless the train
flags say `--device cpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..data.synthetic import make_synthetic_dataset
from ..engine.checkpoints import CheckpointManager
from ..engine.trainer import Trainer
from ..pipelines.nerf_emitter import NerfEmitterPipeline
from ..renderer.grid3d import sphere_sdf_grid
from . import train
from .profiling import Stages

K5 = "mega_pipeline"


def watch(st: Stages) -> None:
    """The stages of a run: pretraining steps (CUDA events), the TSDF
    init, guiding builds, distillations (with their fidelity), takeover
    steps (with the render size and grid they ran at), the bind after a
    restore, eval views, checkpoint saves and restores."""
    st.wrap(NerfEmitterPipeline, "nerf_iteration", events=True, keep_out=True)
    st.wrap(NerfEmitterPipeline, "tsdf_init", keep_out=True)
    st.wrap(NerfEmitterPipeline, "build_emitter_proposal")
    st.wrap(NerfEmitterPipeline, "_maybe_distilled_fn_of", stage="distill", after=lambda p: p.distill_fidelity)
    st.wrap(NerfEmitterPipeline, "takeover_iteration", keep_out=True,
            after=lambda p: (p._takeover_size, int(p.sdf_state.scene.sdf.shape[0])))
    st.wrap(NerfEmitterPipeline, "resume_takeover_bind")
    st.wrap(Trainer, "eval_step")
    st.wrap(Trainer, "save_checkpoint")
    st.wrap(CheckpointManager, "restore")


def summary(st: Stages) -> dict:
    """What the watched stages measured."""
    calls = st.calls
    out: dict = {"k5_launches_by_stage": {k: sum(c["launches"].get(K5, 0) for c in cs) for k, cs in calls.items()}}
    nerf_ms = [x * 1e3 for x in st.seconds("nerf_iteration")]
    if nerf_ms:
        rgb = [float(c["out"]["rgb_loss"]) for c in calls["nerf_iteration"]]
        w = min(10, len(rgb) // 2) or 1
        out["pretrain"] = dict(steps=len(nerf_ms), ms_per_step=sum(nerf_ms[10:]) / max(1, len(nerf_ms[10:])),
                               ms_per_step_over="steps 11 on", seconds=sum(nerf_ms) * 1e-3,
                               rgb_loss_first10=sum(rgb[:w]) / w, rgb_loss_last10=sum(rgb[-w:]) / w)
    if calls.get("tsdf_init"):
        sdf = calls["tsdf_init"][0]["out"].sdf
        out["tsdf_init"] = dict(seconds=st.seconds("tsdf_init")[0], grid=int(sdf.shape[0]),
                                interior_share=float((sdf < 0).float().mean()),
                                fell_back_to_sphere=bool(torch.equal(
                                    sdf, sphere_sdf_grid(int(sdf.shape[0]), radius=0.25, device=sdf.device))))
    out["guiding_build_s"] = st.seconds("build_emitter_proposal")
    out["distillations"] = [dict(seconds=s, fidelity=c["after"], k5_launches=c["launches"].get(K5, 0))
                            for s, c in zip(st.seconds("distill"), calls.get("distill", []))]
    by_size: dict = {}
    for s, c in zip(st.seconds("takeover_iteration"), calls.get("takeover_iteration", [])):
        size, grid = c["after"]
        d = by_size.setdefault(str(size), dict(steps=0, seconds=0.0, grids=[]))
        d["steps"] += 1
        d["seconds"] += s
        if grid not in d["grids"]:
            d["grids"].append(grid)
    for d in by_size.values():
        d["ms_per_step"] = d["seconds"] * 1e3 / d["steps"]
    out["takeover"] = dict(by_size=by_size, ms_per_step=[x * 1e3 for x in st.seconds("takeover_iteration")])
    if calls.get("takeover_iteration"):
        out["takeover"]["last"] = {k: float(v) for k, v in calls["takeover_iteration"][-1]["out"].items()}
    for stage in ("eval_step", "save_checkpoint", "restore", "resume_takeover_bind"):
        out[f"{stage}_s"] = st.seconds(stage)
    return out


def final_scene(trainer: Trainer, cameras: int = 8, size: int = 64) -> dict:
    """The takeover's last grid: its resolution, its interior share and the
    interior's box (unit cube), the share of nodes at redistancing's sqrt(3)
    cap, the SDF at the training cameras' centres (negative: a camera
    inside the solid), and for the first `cameras` training cameras at
    size^2 the share of pixel rays the tracer hits and of rays that start
    on a capped node."""
    pipe = trainer.pipeline
    if pipe.sdf_state is None:
        return {}
    from ..renderer.grid3d import sdf_eval
    from ..renderer.sensors import camera_rays_in_render_space
    from ..renderer.sphere_trace import sphere_trace
    from ..utils import coords

    sdf = pipe.sdf_state.scene.sdf
    cams = trainer.dataset.cameras
    eyes = coords.world_to_unit(cams.camera_to_worlds[:, :3, 3], pipe.config.scene_scale)
    at_eyes = sdf_eval(sdf, eyes.clamp(0.0, 1.0))
    inside = torch.nonzero(sdf[..., 0] < 0).float() / (sdf.shape[0] - 1)
    small = dataclasses.replace(cams, fx=cams.fx * size / cams.width, fy=cams.fy * size / cams.height,
                                cx=cams.cx * size / cams.width, cy=cams.cy * size / cams.height,
                                width=size, height=size)
    hits, capped_starts = [], []
    with torch.no_grad():
        for i in range(min(cameras, len(cams))):
            o, d = camera_rays_in_render_space(small, i, size, size, pipe.config.scene_scale)
            hits.append(sphere_trace(sdf, o, d, pipe.render_config.trace)[1].float().mean())
            capped_starts.append((sdf_eval(sdf, o.clamp(0.0, 1.0)) >= 1.73).float().mean())
    return dict(grid=int(sdf.shape[0]), interior_share=float((sdf < 0).float().mean()),
                interior_box=[inside.amin(0).tolist(), inside.amax(0).tolist()] if len(inside) else None,
                capped_share=float((sdf >= 1.73).float().mean()),
                sdf_at_cameras_min=float(at_eyes.min()), cameras_inside=int((at_eyes < 0).sum()),
                hit_share_by_camera=[float(h) for h in hits],
                capped_ray_starts_by_camera=[float(c) for c in capped_starts])


def finite_metrics(st: Stages) -> bool:
    """Every metric the watched train steps returned is finite."""
    return all(math.isfinite(float(v)) for stage in ("nerf_iteration", "takeover_iteration")
               for c in st.calls.get(stage, []) for v in c["out"].values())


def card() -> dict:
    """The device's name and, on a card, nvidia-smi's name and power limit."""
    if not torch.cuda.is_available():
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi[0]}


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    ours, train_argv = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) if "--" in argv else ([], argv)
    ap = argparse.ArgumentParser(prog="method_run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(ours)
    cpu = "--device" in train_argv and train_argv[train_argv.index("--device") + 1] == "cpu"
    dev = torch.device("cpu" if cpu else "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or Path(tmp)
        if "--datacfg.data" not in train_argv:
            scene = make_synthetic_dataset(out / "scene", n_views=args.views, width=args.res, height=args.res,
                                           seed=args.seed)
            train_argv += ["--datacfg.data", str(scene)]
        if "--output-dir" not in train_argv:
            train_argv += ["--output-dir", str(out / "runs")]
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with Stages(dev) as st:
            watch(st)
            trainer = train.main(train_argv)
        rows = [json.loads(ln) for ln in (trainer.run_dir / "logs/events.jsonl").read_text().splitlines()]
        rec = dict(card(), argv=train_argv, seconds=time.perf_counter() - t0, **summary(st),
                   metrics_finite=finite_metrics(st), final_scene=final_scene(trainer),
                   rows=[{k: v for k, v in r.items() if k != "ts"} for r in rows],
                   peak_mem_gb=None if cpu else torch.cuda.max_memory_allocated() / 2**30)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
