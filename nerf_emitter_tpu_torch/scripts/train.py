"""Train CLI (port of nerf_emitter_tpu/scripts/train.py):

    python -m nerf_emitter_tpu_torch.scripts.train <method> --datacfg.data <scene> [--flags]

Methods are configs/methods.py's; every field of ExperimentConfig is a
flag (--pipeline.takeover-step 100, --train.num-rays-per-batch 4096, ...).
The run lives on `--device` (default cuda; no CUDA device is an error,
never a quiet fallback to the CPU). `--resume` continues from the run
directory's latest checkpoint, `--load-nerf-only` restores its NeRF alone,
and `--override-start-step N` starts the loop at step N; `--viewer-port P`
serves the web viewer on port P.

Across ranks (parallel/mesh.py): with NERF_EMITTER_COORDINATOR (host:port
of rank 0), NERF_EMITTER_NUM_PROCESSES and NERF_EMITTER_PROCESS_ID set, the
process joins that process group (NERF_EMITTER_COORDINATOR=auto: torchrun's
variables); `--device cpu` then runs gloo ranks on the CPU. A process on
CUDA with no such variables that sees more than one card spawns one rank
per card itself (torch.multiprocessing, on a free localhost port); a rank
that fails fails the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import sys

import torch
import torch.distributed as dist

from ..configs.cli import add_dataclass_args, dataclass_from_args
from ..configs.methods import ExperimentConfig, all_method_configs
from ..parallel.mesh import maybe_initialize_distributed


def _flatten_defaults(cfg, prefix: str = "") -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            out.update(_flatten_defaults(v, prefix=f"{name}."))
        else:
            out[name] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="train", description="NeRF-emitter training on PyTorch")
    subs = parser.add_subparsers(dest="method", required=True)
    methods, descriptions = all_method_configs()
    for name, factory in methods.items():
        sub = subs.add_parser(name, help=descriptions.get(name, ""))
        add_dataclass_args(sub, ExperimentConfig)
        sub.add_argument("--resume", action="store_true", help="continue from the latest checkpoint")
        sub.add_argument("--load-nerf-only", action="store_true",
                         help="restore only the NeRF's train state from the checkpoint")
        sub.add_argument("--override-start-step", type=int, default=None)
        sub.set_defaults(**_flatten_defaults(factory()))
    return parser


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv: list, world: int, port: int) -> None:
    """One spawned rank: the process group's variables, then the CLI."""
    os.environ.update(NERF_EMITTER_COORDINATOR=f"127.0.0.1:{port}", NERF_EMITTER_NUM_PROCESSES=str(world),
                      NERF_EMITTER_PROCESS_ID=str(rank))
    main(argv)


def main(argv=None):
    """Run the CLI; returns the Trainer (None in the process that spawned
    one rank per card)."""
    argv = list(argv if argv is not None else sys.argv[1:])
    args = build_parser().parse_args(argv)
    config = dataclass_from_args(ExperimentConfig, args)
    config.method_name = args.method
    joined = dist.is_initialized()
    if not maybe_initialize_distributed(config.device):
        if torch.device(config.device).type == "cuda" and torch.cuda.device_count() > 1:
            world = torch.cuda.device_count()
            print(f"{world} CUDA devices: one rank each", flush=True)
            torch.multiprocessing.spawn(_rank_main, args=(argv, world, free_port()), nprocs=world, join=True)
            return None
    elif not joined:
        print(f"process group: {dist.get_backend()}, rank {dist.get_rank()} of {dist.get_world_size()}", flush=True)
    try:
        trainer = _train(args, config)
        if dist.is_initialized() and not joined:
            dist.barrier()  # every rank ends its run before any leaves the group
        return trainer
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()


def _train(args, config: ExperimentConfig):
    from ..engine.trainer import Trainer

    trainer = Trainer(config)
    trainer.setup()
    start_step = 0
    if args.resume or args.override_start_step is not None:
        latest = trainer.ckpt.latest_step()
        if latest is None:
            print("no checkpoint to resume from; starting fresh")
        else:
            trainer.load_checkpoint(latest, nerf_only=args.load_nerf_only)
            start_step = args.override_start_step if args.override_start_step is not None else latest
            if args.load_nerf_only:
                print("load-nerf-only: restored NeRF state only")
            print(f"resumed from step {latest}, starting at {start_step}")
    trainer.train(start_step=start_step)
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
