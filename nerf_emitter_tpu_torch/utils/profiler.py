"""Wall-clock timing of host functions and blocks, and device traces (port
of nerf_emitter_tpu/utils/profiler.py): per-name call counts and totals,
printed as means at exit, on standard error (standard output's last line
stays a program's own: `chip_smoke.py`'s result, say); `trace` writes a
torch.profiler Chrome trace where the reference writes a jax.profiler one.

The clock does not wait for the device: CUDA work is queued
asynchronously, so a block's time is its host time, plus device time only
where the block itself waits for the device (reading a value, say). For
device time use `trace`, `scripts/profiling.device_trace` or CUDA events.
"""

from __future__ import annotations

import atexit
import functools
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

_STATS: dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [count, total seconds]
_ENABLED = True


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def _record(name: str, seconds: float) -> None:
    s = _STATS[name]
    s[0] += 1
    s[1] += seconds


def time_function(fn=None, *, name: Optional[str] = None):
    """Decorator: accumulate the wall time of every call under `name`
    (default: the function's qualified name)."""

    def deco(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not _ENABLED:
                return f(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                _record(label, time.perf_counter() - t0)

        return wrapper

    return deco(fn) if fn is not None else deco


@contextmanager
def time_block(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _ENABLED:
            _record(name, time.perf_counter() - t0)


@contextmanager
def trace(log_dir, enabled: bool = True):
    """Profile the block with torch.profiler (the CPU, and CUDA where torch
    sees a card) and write its Chrome trace to `log_dir`/trace.json (view
    it in Perfetto or chrome://tracing)."""
    if not enabled:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def summary() -> str:
    lines = ["profiler summary (mean over calls):"]
    for name, (count, total) in sorted(_STATS.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {name}: {total / max(count, 1) * 1e3:.2f} ms x {count}")
    return "\n".join(lines)


@atexit.register
def _print_summary():
    if _ENABLED and _STATS:
        print(summary(), file=sys.stderr, flush=True)
