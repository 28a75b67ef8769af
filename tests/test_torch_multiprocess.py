"""The train CLI across two gloo processes on the CPU (the port's
counterpart of tests/test_multihost.py, at a size tier-1 affords): two
`python -m`-style processes joined by NERF_EMITTER_COORDINATOR,
NERF_EMITTER_NUM_PROCESSES and NERF_EMITTER_PROCESS_ID run sdf-nerfacto on
a synthetic scene, 12 NeRF steps then 9 takeover steps. Both ranks' losses
are equal at every logged step; rank 0 alone writes events, eval images
and checkpoints; both exit 0."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from nerf_emitter_tpu_torch.data.synthetic import make_synthetic_dataset
from nerf_emitter_tpu_torch.scripts.train import free_port

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# the CLI, with TensorBoard left out (its import costs seconds) and the
# distillation at 2^8 queries a step (its default 2^14 is cut for the CPU)
BOOT = ("import functools, sys; sys.modules['torch.utils.tensorboard'] = None; "
        "from nerf_emitter_tpu_torch.pipelines import nerf_emitter as tne; "
        "tne.DistillConfig = functools.partial(tne.DistillConfig, batch=1 << 8); "
        "from nerf_emitter_tpu_torch.scripts.train import main; main(sys.argv[1:])")
FLAGS = ["--pipeline.takeover-step", "12", "--max-num-iterations", "21", "--train.num-rays-per-batch", "64",
         "--model.num-proposal-samples", "[16, 8]", "--model.num-nerf-samples", "8", "--pipeline.distill-steps", "2",
         "--pipeline.spp", "2", "--pipeline.batch-size", "2", "--pipeline.takeover-image-size", "8",
         "--pipeline.tsdf-init-res", "16", "--steps-per-eval-image", "15", "--steps-per-save", "15"]


def test_train_cli_across_two_gloo_processes(tmp_path):
    data = make_synthetic_dataset(tmp_path / "scene", n_views=8, width=16, height=16)
    port = free_port()
    argv = ["sdf-nerfacto", "--datacfg.data", str(data), "--output-dir", str(tmp_path / "out"), "--experiment-name",
            "ranks", "--device", "cpu", *FLAGS]
    procs = []
    for rank in range(2):
        env = dict(os.environ, NERF_EMITTER_COORDINATOR=f"127.0.0.1:{port}", NERF_EMITTER_NUM_PROCESSES="2",
                   NERF_EMITTER_PROCESS_ID=str(rank), OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, "-c", BOOT, *argv], cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    assert "mesh: 2 ranks on axis 'data' (gloo)" in outs[0] and "mesh:" not in outs[1]

    run_dir = tmp_path / "out/ranks/sdf-nerfacto"
    rows = [json.loads(line) for line in (run_dir / "logs/events.jsonl").read_text().splitlines()]
    train_rows = {r["step"]: r for r in rows if "loss" in r}
    assert sorted(train_rows) == [0, 10, 20]  # once each: rank 1 writes no rows
    assert "view_loss" in train_rows[20] and "rgb_loss" in train_rows[10]
    printed = {int(s): float(v) for s, v in re.findall(r"^rank 1 step (\d+) loss (\S+)$", outs[1], re.M)}
    assert printed == {s: r["loss"] for s, r in train_rows.items()}
    assert [r["step"] for r in rows].count(15) == 1 and (run_dir / "logs/images/eval_rgb_000015.exr").exists()
    assert sorted(p.name for p in (run_dir / "checkpoints").iterdir()) == ["21"]
    assert (run_dir / "config.json").exists()
