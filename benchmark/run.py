"""One run of one cell of the port's benchmark (`BENCHMARK.json`).

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell's configuration (the
`file` that `BENCHMARK.json` gives it), traffic mix
(`benchmark/traffic/<traffic>.json`, whose `driver` names the general
generator in `benchmark/drivers/`) and limits
(`benchmark/limits/<cell>.json`), sets the program up from the seed,
measures for --seconds seconds (or, with --trace 1, traces a short window
and reads each per-layer metric with its reader,
`benchmark/metrics/<metric>.py`), then frees the program's state and
compares what the timed path produced with the plain PyTorch reference
(`benchmark/reference/`). The last line of standard output is one JSON
object: correct, attempted, failed, metrics, device, the traced run's
breakdown, and the compared numbers beside their limits (`checks`). It
needs a CUDA card and never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names the run's process may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_emitter_tpu")
# the traced reading's counts and work, logged on standard error
TRACE_LOG = ("steps", "period_s", "flops", "encoding_lookups", "encoding_bytes", "counts", "launches", "spans",
             "program_counts", "program_spans")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Run:
    """One run's cell, files, seed and device."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device, bench: dict,
                 overrides: dict | None = None, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
        self.cell = cells[workload]
        self.name, self.seed, self.seconds, self.trace, self.device = workload, int(seed), seconds, trace, device
        config = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.config = load_json(root / config["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = load_json(root / "benchmark" / "limits" / f"{workload}.json")
        for part, values in (overrides or {}).items():  # the CPU tests' tiny sizes
            target = self.traffic if part == "traffic" else self.config[part]
            target.update(values)
        self.end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]

    def make_weights(self, shapes: dict) -> dict:
        from . import scene
        from .drivers.common import derive

        return scene.make_weights(shapes, derive(self.seed, "weights"), self.device)

    log = staticmethod(log)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def read_metric(name: str, reading: dict, root: Path = ROOT):
    """The per-layer metric's reader, `benchmark/metrics/<name>.py`:
    read(reading) -> value or None (nothing to read)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  root / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(reading)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, *, device=None, overrides=None, root: Path = ROOT) -> int:
    """The run. `device` and `overrides` are for the CPU tests alone (a
    tiny cell on the CPU); the command line always runs on the card.
    `root` holds `BENCHMARK.json` and the benchmark's data files
    (configurations, traffic, limits, readers): a copy with a cell added
    runs with this code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(Path(root) / "BENCHMARK.json")
    import torch

    from . import program, roofline

    for k in program.PORT_ENV:
        os.environ.pop(k, None)
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            log(f"error: the cell needs {chips} CUDA card(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = "cuda:0"
        log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {power_limit()}; "
            f"peaks used: bf16 {roofline.H100_BF16_FLOPS:.4g} FLOP/s, HBM {roofline.H100_BYTES_PER_S:.4g} B/s "
            f"(H100 SXM data sheet); "
            f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.set_num_threads(4)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), torch.device(device), bench, overrides,
              Path(root))
    driver = importlib.import_module(f"benchmark.drivers.{run.traffic['driver']}").Driver(run)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    setup_s = time.perf_counter() - T_START
    log(f"setup_s {setup_s:.4f}")
    breakdown, dev_extra = None, {}
    if run.trace:
        reading = driver.trace_window()
        reading["peak_flops"] = roofline.H100_BF16_FLOPS
        metrics = {}
        for m in run.per_layer:
            v = read_metric(m["name"], reading, Path(root))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_extra = {"busy_s": reading.get("busy_s", 0.0), "window_s": reading.get("window_s", 0.0)}
        breakdown = {"device_ops": reading.get("device_ops", []), "idle_gaps": reading.get("idle_gaps", [])}
        log("trace: " + json.dumps({k: reading[k] for k in TRACE_LOG if k in reading}))
    else:
        e2e = driver.window(run.seconds)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in run.end_to_end}
    attempted, failed = driver.attempted(), driver.failed()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = driver.check()
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    found = forbidden_modules()
    if found:
        log(f"error: the run's process holds {found}")
        return 4
    # a number that is not finite passes no limit, and is printed as null
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None, "limit": run.limits[k]}
              for k in run.limits}
    correct = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": run.cell["chips"], "memory_peak_bytes": int(peak), **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    if "_worst" in numbers:
        log(f"worst leaves: {numbers['_worst']}; leaves compared in the change: {numbers.get('_kept')}")
    for k, c in checks.items():
        log(f"{k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
