"""Wall-clock timing of host functions and blocks (port of the timing part
of nerf_emitter_tpu/utils/profiler.py): per-name call counts and totals,
printed as means at exit, on standard error (standard output's last line
stays a program's own: `chip_smoke.py`'s result, say).

The clock does not wait for the device: CUDA work is queued
asynchronously, so a block's time is its host time, plus device time only
where the block itself waits for the device (reading a value, say). For
device time use `scripts/profiling.device_trace` or CUDA events.
"""

from __future__ import annotations

import atexit
import functools
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
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


def summary() -> str:
    lines = ["profiler summary (mean over calls):"]
    for name, (count, total) in sorted(_STATS.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {name}: {total / max(count, 1) * 1e3:.2f} ms x {count}")
    return "\n".join(lines)


@atexit.register
def _print_summary():
    if _ENABLED and _STATS:
        print(summary(), file=sys.stderr, flush=True)
