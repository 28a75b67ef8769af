"""The readings that the limits of `benchmark/limits/<cell>.json` are set
from, in one process (set-up is long; the kernels build once):

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 [--control-seeds 4,5,6]
        [--fault unchanged|half_batch|altered|no_backward] [--emitter-only] [--out <file>]

For each of --seeds: the program set up as in a run (no window), then the
numbers of the comparison with the reference (the lower reading: the
largest over a dozen seeds or more). With --fault, the same with that
fault planted under the timed path (benchmark/faults.py). For each of
--control-seeds: the control, the reference in the precision below the
configuration's (fp8 for the bf16 MLPs) in the program's place (the upper
reading). One JSON line per seed on standard output, and in --out. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import torch

from . import faults, run as run_mod


def _clean(numbers: dict) -> dict:
    return {k: v for k, v in numbers.items() if not k.startswith("_")}


def main(argv=None, *, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--emitter-only", action="store_true",
                    help="the takeover's emitter numbers alone (no followed steps or guiding)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            print("error: no CUDA card", file=sys.stderr)
            return 3
        device = "cuda:0"
    bench = run_mod.load_json(run_mod.ROOT / "BENCHMARK.json")
    out = open(args.out, "a") if args.out else None

    def emit(row: dict) -> None:
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    def driver_for(seed: int):
        r = run_mod.Run(args.workload, seed, 0.0, False, torch.device(device), bench, overrides)
        return importlib.import_module(f"benchmark.drivers.{r.traffic['driver']}").Driver(r)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.perf_counter()
        d = driver_for(seed)
        kind = d.run.traffic["driver"]
        plant = faults.FAULTS[args.fault](kind) if args.fault else contextlib.nullcontext()
        with plant:
            d.setup()
        d.release()
        numbers = d.check(emitter_only=True) if args.emitter_only else d.check()
        emit({"workload": args.workload, "seed": seed, "side": args.fault or "program", "numbers": _clean(numbers),
              "worst": numbers.get("_worst"), "s": time.perf_counter() - t0})
        del d
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for seed in controls:
        t0 = time.perf_counter()
        d = driver_for(seed)
        d.inputs_from_seed()
        numbers = d.control(emitter_only=True) if args.emitter_only else d.control()
        emit({"workload": args.workload, "seed": seed, "side": "control", "numbers": _clean(numbers),
              "worst": numbers.get("_worst"), "s": time.perf_counter() - t0})
        del d
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
