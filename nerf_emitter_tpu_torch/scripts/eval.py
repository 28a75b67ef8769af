"""Eval CLI: image metrics of a run's eval split, relighting included ->
JSON (port of nerf_emitter_tpu/scripts/eval.py).

    python -m nerf_emitter_tpu_torch.scripts.eval \
        --load-config outputs/lego/sdf-nerfacto/config.json \
        [--emitter-path envmaps/courtyard.exr --test-data data/lego_relit] \
        [--spp 64] [--output-path metrics.json] [--device cuda]

Loads the run's config, points the eval split at `--test-data` (the
relighting ground truth), restores the checkpoint, then with
`--emitter-path` swaps the serving emitter for that envmap through
`set_relight_emitter` (after the restore: the checkpoint's state keeps the
guiding type it was trained with), renders every eval view at `--spp` and
writes the mean metrics and their standard deviations. The run's
config.json is never rewritten.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..utils.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="eval")
    ap.add_argument("--load-config", type=Path, required=True)
    ap.add_argument("--output-path", type=Path, default=Path("metrics.json"))
    ap.add_argument("--emitter-path", type=Path, default=None,
                    help="relighting envmap (exr/npy); replaces the NeRF emitter")
    ap.add_argument("--test-data", type=Path, default=None)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--checkpoint-step", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..configs.cli import load_config
    from ..engine.trainer import Trainer

    config = load_config(args.load_config)
    config.device = str(dev)
    if args.test_data is not None:
        config.datacfg.test_data = args.test_data

    trainer = Trainer(config)
    trainer.setup()
    try:
        trainer.load_checkpoint(args.checkpoint_step)
    except FileNotFoundError:
        print("warning: no checkpoint found; evaluating fresh init")

    pipeline = trainer.pipeline
    if args.emitter_path is not None and pipeline.sdf_state is not None:
        pipeline.set_relight_emitter(args.emitter_path)

    ds = trainer.eval_dataset or trainer.dataset
    metrics = pipeline.get_average_eval_image_metrics(ds, torch.Generator(device=dev).manual_seed(0),
                                                      spp=args.spp, get_std=True)
    out = {
        "experiment": str(config.experiment_name),
        "method": config.method_name,
        "checkpoint_dir": str(trainer.run_dir / "checkpoints"),
        "results": metrics,
    }
    args.output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(args.output_path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
