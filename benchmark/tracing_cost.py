"""What the port's own tracing costs and reads in a cell's traced period:

    python3 -m benchmark.tracing_cost --workload <cell> --seed <n> --port 0,1,1,0 [--out <file>]

from the root of a checkout. It sets the cell's program up as a run does,
then traces one period for each entry of --port, with the port's tracing
off (0) or on (1) (the driver's own `trace_window`, which a run traces
with it on), and prints one JSON line per period: its host seconds, the
cell's per-layer metrics by their readers in `benchmark/metrics/`, the
benchmark wrappers' counts beside the port's counters, the port's spans,
and the idle gaps. It makes no comparison with the reference. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from . import roofline, run as run_mod


def counts_pairs(reading: dict) -> dict:
    """Each count of the benchmark's wrappers beside the port's counter that
    should equal it: [wrappers', port's]."""
    em = reading.get("counts", {}).get("emitter", {})
    pc = reading.get("program_counts", {})
    pairs = {"emitter.rays": [em.get("rays", 0) + em.get("grad_rays", 0), pc.get("emitter.rays", 0)],
             "emitter.grad_rays": [em.get("grad_rays", 0), pc.get("emitter.grad_rays", 0)],
             "emitter.rerun_rays": [em.get("recompute_rays", 0), pc.get("emitter.rerun_rays", 0)],
             "guiding.probe_rays": [reading.get("counts", {}).get("probes", {}).get("rays", 0),
                                    pc.get("guiding.probe_rays", 0)]}
    return {k: [int(a), int(b)] for k, (a, b) in pairs.items()}


def main(argv=None, *, device=None, overrides=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--port", default="0,1", help="the port's tracing in each traced period, in order")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    order = [int(s) for s in args.port.split(",") if s]
    if device is None:
        if not torch.cuda.is_available():
            print("error: no CUDA card", file=sys.stderr)
            return 3
        device = "cuda:0"
        run_mod.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: "
                    f"{run_mod.power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.set_num_threads(4)
    bench = run_mod.load_json(run_mod.ROOT / "BENCHMARK.json")
    run = run_mod.Run(args.workload, args.seed, 0.0, True, torch.device(device), bench, overrides)
    driver = importlib.import_module(f"benchmark.drivers.{run.traffic['driver']}").Driver(run)
    t0 = time.perf_counter()
    driver.setup()
    run_mod.log(f"setup {time.perf_counter() - t0:.2f} s")
    out = open(args.out, "a") if args.out else None
    for i, port in enumerate(order):
        reading = driver.trace_window(bool(port))
        reading["peak_flops"] = roofline.H100_BF16_FLOPS
        metrics = {m["name"]: run_mod.read_metric(m["name"], reading) for m in run.per_layer}
        row = {"workload": args.workload, "seed": args.seed, "period": i, "port": port,
               "period_s": reading["period_s"], "window_s": reading["window_s"], "busy_s": reading["busy_s"],
               "idle_s": reading["idle_s"], "steps": reading.get("steps"), "metrics": metrics,
               "counts": counts_pairs(reading), "program_counts": reading["program_counts"],
               "program_spans": reading["program_spans"], "idle_gaps": reading["idle_gaps"]}
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
