"""Round 5's end-task protocol (RESULTS_r05.md, scripts/round5/stages.sh) run
in-process through the port's tools, every stage timed:

    python -m nerf_emitter_tpu_torch.scripts.endtask_run [--arms baseline distilled] [--out DIR] \
        [--views 60] [--res 128] [--spp 32] [--relit-views 30] [--mesh-res 192] [--n-points 250000] \
        [-- extra train flags]

1. gen_data: the composite object with banded albedo, `--views` random
   views at `--res`^2 and `--spp` (seed 0), under the procedural sky;
2. the relit scene: the same generator under env.exr rolled by half its
   width (env_relit.exr), `--relit-views` views;
3. the ground-truth mesh: the exporter on gt_sdf.npy at `--mesh-res`;
4. `train sdf-nerfacto` (2,000 + 320 steps) with the round's flags
   (recipe diffuse-12-relativel1-hqq-r128, spp 16, 8 attached, 2 images a
   step); the `baseline` arm (prod5f) pins the emitter to the full K5 query
   (no distilled cache, samples (256, 96, 48)); the `distilled` arm
   (prod5_dl) turns the cache on and starts from the baseline's step-2,000
   checkpoint with `--resume --load-nerf-only --override-start-step 2000`
   (a baseline arm of this `--out` must have run first);
5. eval at spp 32 (NVS), the same views denoised by the learned denoiser
   fitted on the training views (`eval_nvs_learned`; the round has no
   such number), then relit (`--emitter-path env_relit.exr --test-data
   <relit scene>`);
6. the exporter at `--mesh-res` from the run, chamfer against the
   ground-truth mesh, and the recovered albedo against gt_albedo.npy near
   the surface (`albedo_against_gt`; the round reported no such number).

Prints one JSON line per stage (seconds, the port's kernel launches, what
it returned) and, last, one line per arm with the three end-task numbers
beside RESULTS_r05.md's. Checkpoints are saved at the takeover step (2,000:
the distilled arm's seed) and at the end, where the round saved every 50
steps for crash resumption. Train flags after `--` are appended (a CPU
rehearsal shortens the run with them). On the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..engine.checkpoints import CheckpointManager
from ..utils import exr
from ..utils.device import resolve_device
from . import chamfer, eval as eval_cli, exporter, gen_data, method_run, train
from .profiling import Stages

# RESULTS_r05.md:84-215 (results/r5/*.json): the JAX package's numbers for the two arms
REFERENCE = {
    "baseline": {"experiment": "prod5f", "nvs_psnr": 20.073, "nvs_ssim": 0.450, "relight_psnr": 17.33,
                 "chamfer": 0.01339},
    "distilled": {"experiment": "prod5_dl", "nvs_psnr": 20.265, "nvs_ssim": 0.470, "relight_psnr": 17.16,
                  "chamfer": 0.01367},
}
ARM_FLAGS = {
    "baseline": ["--pipeline.distill-emitter", "false", "--pipeline.emitter-samples", "[256, 96, 48]"],
    "distilled": ["--pipeline.distill-emitter", "true", "--pipeline.emitter-samples", "[256, 96, 48]"],
}
K1 = "fused_density"


class Run:
    """Times stages (host clock, the device synchronised) and prints a line
    for each."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.lines: dict = {}

    def stage(self, name: str, fn, **extra):
        if self.cuda:
            torch.cuda.synchronize()
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        out = fn()
        if self.cuda:
            torch.cuda.synchronize()
        line = dict(stage=name, seconds=time.perf_counter() - t0,
                    launches={k: n - before.get(k, 0) for k, n in kernels.launches.items() if n != before.get(k, 0)},
                    **extra)
        self.lines[name] = line
        print(json.dumps(line, default=str), flush=True)
        return out


def make_scenes(run: Run, data: Path, args, dev: str) -> tuple[Path, Path, Path, Path]:
    """The scene, the relit scene, the relighting envmap and the GT mesh
    (each made once per data directory)."""
    scene, relit, env_relit, gt_mesh = data / "scene", data / "scene_relit", data / "env_relit.exr", data / "gt_mesh"
    common = ["--object", "composite", "--albedo", "bands", "--width", str(args.res), "--height", str(args.res),
              "--spp", str(args.spp), "--path-type", "random", "--seed", "0", "--resume", "--device", dev]
    run.stage("gen_data", lambda: gen_data.main(common + ["--n-views", str(args.views), "--out", str(scene)]))

    def relight_gt():
        img = exr.read_exr(scene / "env.exr")
        exr.write_exr(env_relit, np.roll(img[..., :3], img.shape[1] // 2, axis=1))
        return gen_data.main(common + ["--envmap", str(env_relit), "--n-views", str(args.relit_views),
                                       "--out", str(relit)])

    run.stage("gen_data_relit", relight_gt)
    run.stage("gt_mesh", lambda: exporter.main(["mi-marching-cubes", "--sdf-volume", str(scene / "gt_sdf.npy"),
                                                "--resolution", str(args.mesh_res), "--output-dir", str(gt_mesh),
                                                "--device", dev]))
    return scene, relit, env_relit, gt_mesh


def keep_seed(seed_dir: Path, step: int):
    """An `after` for CheckpointManager.save: copies the checkpoint of
    `step` to seed_dir (the next save deletes it)."""
    def after(mgr: CheckpointManager):
        if mgr.latest_step() == step and not (seed_dir / str(step)).exists():
            shutil.copytree(mgr.directory / str(step), seed_dir / str(step))
    return after


def albedo_against_gt(albedo: np.ndarray, gt_albedo: np.ndarray, gt_sdf: np.ndarray) -> dict:
    """The recovered albedo grid against the ground truth on the nodes
    within one node spacing of the GT surface (where the images constrain
    it): the per-channel ratio of the means and the mean relative error."""
    from ..renderer.grid3d import grid_sample

    res = albedo.shape[0]
    xs = torch.linspace(0.0, 1.0, res)
    nodes = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"), dim=-1).reshape(-1, 3)
    near = grid_sample(torch.from_numpy(gt_sdf), nodes)[:, 0].abs() <= 1.0 / (res - 1)
    got = torch.from_numpy(albedo).reshape(-1, 3)[near]
    want = grid_sample(torch.from_numpy(gt_albedo), nodes[near])
    return dict(nodes=int(near.sum()), ratio_of_means=(got.mean(0) / want.mean(0)).tolist(),
                mean_rel_err=float(((got - want).abs() / want).mean()))


def scene_frames(scene: Path, data_scale: float, render_scale: float) -> dict:
    """Where the generator's ground truth lands in the trainer's frame. The
    generator renders the unit cube as world [-1, 1] (scale 1); the parser
    multiplies camera positions by `data_scale`, and the pipeline's render
    cube is world [-render_scale, render_scale]. Returns the GT interior's
    box in the generator's unit cube and in the render cube, and the
    dataset's object_aabb (the carve-out and TSDF box, taken as it is) in
    the render cube."""
    sdf = np.load(scene / "gt_sdf.npy")[..., 0]
    inside = np.argwhere(sdf < 0) / (sdf.shape[0] - 1)
    gt_unit = np.stack([inside.min(0), inside.max(0)])
    to_render = lambda w: (np.asarray(w) / render_scale + 1.0) * 0.5  # noqa: E731
    box = json.loads((scene / "transforms.json").read_text())["object_aabb"]
    return dict(gt_box_generator_unit=gt_unit.tolist(),
                gt_box_render_unit=to_render((gt_unit * 2.0 - 1.0) * data_scale).tolist(),
                object_aabb_render_unit=to_render(box).tolist())


def eval_nvs_learned(cfg: Path, dev: str, spp: int) -> dict:
    """eval.py's NVS metrics (the same draws: a generator seeded 0) with
    every view denoised by the learned denoiser, fitted first on the
    training views at the default DenoiserConfig (fit_scene_denoiser from
    a generator seeded 17)."""
    from ..configs.cli import load_config
    from ..engine.train_loop import eval_image_metrics
    from ..engine.trainer import Trainer

    config = load_config(cfg)
    config.device = dev
    trainer = Trainer(config)
    trainer.setup()
    trainer.load_checkpoint()
    pipe, ds = trainer.pipeline, trainer.eval_dataset or trainer.dataset
    loss = pipe.fit_scene_denoiser(torch.Generator(device=dev).manual_seed(17), trainer.dataset)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows: dict[str, list] = {}
    for i in range(ds.images.shape[0]):
        out = pipe.render_camera_outputs(ds, i, gen, spp=spp, denoise="learned")
        for name, v in eval_image_metrics(out["rgb"], ds.images[i], is_hdr=ds.is_hdr).items():
            rows.setdefault(name, []).append(float(v))
    return {name: float(np.mean(v)) for name, v in rows.items()} | {
        f"{name}_std": float(np.std(v)) for name, v in rows.items()} | {"fit_loss": loss}


def run_arm(run: Run, arm: str, out: Path, scene: Path, relit: Path, env_relit: Path, gt_mesh: Path, args,
            dev: str, extra: list) -> dict:
    ref = REFERENCE[arm]
    exp = ref["experiment"]
    runs, seed_dir = out / "runs", out / "seed_checkpoint"
    argv = ["sdf-nerfacto", "--datacfg.data", str(scene), "--output-dir", str(runs), "--experiment-name", exp,
            "--opt-config-name", "diffuse-12-relativel1-hqq-r128", "--pipeline.spp", "16",
            "--pipeline.spp-attached", "8", "--pipeline.batch-size", "2", "--steps-per-eval-image", "10000",
            "--device", dev, *ARM_FLAGS[arm]]
    # the seed of the distilled arm: the checkpoint at the takeover (2,000)
    pretrain = getattr(train.build_parser().parse_args(argv + extra), "pipeline.takeover_step")
    argv += ["--steps-per-save", str(pretrain), *extra]
    if arm == "distilled":
        if not (seed_dir / str(pretrain)).exists():
            raise FileNotFoundError(f"the distilled arm starts from the baseline's step-{pretrain} checkpoint, "
                                    f"which is not in {seed_dir}: run the baseline arm into this --out first")
        ckpts = runs / exp / "sdf-nerfacto" / "checkpoints"
        shutil.rmtree(ckpts, ignore_errors=True)
        shutil.copytree(seed_dir / str(pretrain), ckpts / str(pretrain))
        argv += ["--resume", "--load-nerf-only", "--override-start-step", str(pretrain)]
    with Stages(torch.device(dev)) as st:
        method_run.watch(st)
        if arm == "baseline":
            st.wrap(CheckpointManager, "save", after=keep_seed(seed_dir, pretrain))
        trainer = run.stage(f"{arm}/train", lambda: train.main(argv), argv=argv)
    train_line = run.lines[f"{arm}/train"]
    masks = trainer.dataset.masks
    train_line.update(method_run.summary(st), final_scene=method_run.final_scene(trainer),
                      gt_mask_share_by_camera=None if masks is None else masks[:8].mean((1, 2, 3)).tolist(),
                      frames=scene_frames(scene, trainer.config.datacfg.scene_scale,
                                          trainer.config.pipeline.scene_scale),
                      metrics_finite=method_run.finite_metrics(st),
                      k1_launches_by_stage={k: sum(c["launches"].get(K1, 0) for c in cs)
                                            for k, cs in st.calls.items()})
    print(json.dumps({**{k: v for k, v in train_line.items() if k != "argv"}, "stage": f"{arm}/train_summary"},
                     default=str), flush=True)
    cfg = trainer.run_dir / "config.json"
    del trainer
    if dev == "cuda":
        torch.cuda.empty_cache()
    nvs = run.stage(f"{arm}/eval_nvs", lambda: eval_cli.main([
        "--load-config", str(cfg), "--spp", "32", "--output-path", str(out / f"e2e_metrics_{arm}.json"),
        "--device", dev]))
    nvs_learned = run.stage(f"{arm}/eval_nvs_learned", lambda: eval_nvs_learned(cfg, dev, 32))
    rel = run.stage(f"{arm}/eval_relight", lambda: eval_cli.main([
        "--load-config", str(cfg), "--emitter-path", str(env_relit), "--test-data", str(relit), "--spp", "32",
        "--output-path", str(out / f"relight_metrics_{arm}.json"), "--device", dev]))
    mesh = out / f"mesh_{arm}"
    run.stage(f"{arm}/export", lambda: exporter.main([
        "mi-marching-cubes", "--load-config", str(cfg), "--resolution", str(args.mesh_res),
        "--output-dir", str(mesh), "--device", dev]))
    ch = run.stage(f"{arm}/chamfer", lambda: chamfer.main([
        str(mesh / "mesh.ply"), str(gt_mesh / "mesh.ply"), "--n-points", str(args.n_points),
        "--output-path", str(out / f"chamfer_{arm}.json"), "--device", dev]))
    albedo = albedo_against_gt(np.load(mesh / "albedo.npy"), np.load(scene / "gt_albedo.npy"),
                               np.load(scene / "gt_sdf.npy"))
    return dict(arm=arm, experiment=exp, nvs=nvs["results"], nvs_learned=nvs_learned, relight=rel["results"],
                chamfer=ch["chamfer"],
                albedo_vs_gt=albedo, reference=ref, seconds={k: v["seconds"] for k, v in run.lines.items()})


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    ours, extra = (argv[:argv.index("--")], argv[argv.index("--") + 1:]) if "--" in argv else (argv, [])
    ap = argparse.ArgumentParser(prog="endtask_run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="+", choices=list(REFERENCE), default=["baseline"])
    ap.add_argument("--out", type=Path, default=None, help="default: a temporary directory")
    ap.add_argument("--views", type=int, default=60)
    ap.add_argument("--relit-views", type=int, default=30)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--mesh-res", type=int, default=192)
    ap.add_argument("--n-points", type=int, default=250_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(ours)
    dev = resolve_device(args.device)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or Path(tmp)
        run = Run(dev)
        scenes = make_scenes(run, out, args, str(dev))
        for arm in args.arms:
            rec = run_arm(run, arm, out, *scenes, args, str(dev), extra)
            rec.update(method_run.card())
            results.append(rec)
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    main()
