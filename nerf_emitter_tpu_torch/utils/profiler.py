"""The port's tracing (port of nerf_emitter_tpu/utils/profiler.py, made
device-aware): named spans and counters at the program's own stages, off
unless switched on with `enable()`.

- `span(name)`, a context manager and a decorator. While tracing is on,
  each span opens a torch.profiler range `nek::<name>` (so it sits on a
  profiler trace's timeline, whose clock the device's activities share),
  adds the call's host seconds under its name and, where CUDA is in use
  and the current stream is not capturing a graph, records a pair of CUDA
  events on that stream: their gap is the span's time on the device's
  clock. Events are read once they have completed, lazily, so nothing
  waits for the device during a step.
- `count(name, n)` adds an int, or a 0-d tensor summed on its device, to a
  counter; `counters()` reads them all (a device counter waits for the
  device then).
- `summary()`: host and device ms per span and the counters; printed at
  exit on standard error (standard output's last line stays a program's
  own) where anything was recorded.
- `time_block` and `time_function`: the reference's names for a span.
- `trace(log_dir)` writes a torch.profiler Chrome trace where the reference
  writes a jax.profiler one; the `nek::` ranges show in it.

While tracing is off a span costs one test of a module-level bool and a
shared null context: no profiler range, no event, no entry. A call site
whose count needs device work (the sum of a mask) tests `enabled()` first,
so nothing is launched for tracing while it is off. Spans and counters may
be entered on autograd's threads (a custom backward, a checkpoint's
recompute): the records are kept under a lock.
"""

from __future__ import annotations

import atexit
import functools
import sys
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch

PREFIX = "nek::"

_ON = False
_LOCK = threading.Lock()
_STATS: dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])  # name -> [calls, host s, device s]
_COUNTS: dict = {}  # name -> int or 0-d tensor
_PENDING: deque = deque()  # (name, start event, end event), in the order the spans closed


def enable(on: bool = True) -> None:
    global _ON
    _ON = bool(on)


def disable() -> None:
    enable(False)


def enabled() -> bool:
    return _ON


def reset() -> None:
    """Forget every span, counter and pending event."""
    with _LOCK:
        _STATS.clear()
        _COUNTS.clear()
        _PENDING.clear()


def _wrap(name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _ON:
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)

    return wrapper


class _Off:
    """A span while tracing is off: enters and exits doing nothing; as a
    decorator it wraps the function in its span by name, decided at each
    call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _wrap(self.name, fn)


_OFF: dict[str, _Off] = {}


def _device_marks() -> bool:
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


class _Span:
    """A span while tracing is on (one per entry)."""

    __slots__ = ("name", "_range", "_start", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._start = None
        if _device_marks():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self._t0
        end = None
        if self._start is not None and _device_marks():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self._range.__exit__(*exc)
        with _LOCK:
            s = _STATS[self.name]
            s[0] += 1
            s[1] += host
            if end is not None:
                _PENDING.append((self.name, self._start, end))
            _resolve(wait=False)
        return False

    def __call__(self, fn):
        return _wrap(self.name, fn)


def span(name: str):
    """A named span: `with span(name):` or `@span(name)`. Nested spans are
    timed each in full (a parent's time includes its children's)."""
    if _ON:
        return _Span(name)
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def _resolve(wait: bool) -> None:
    """Add the device seconds of the completed spans (of all, waiting for
    the device, with `wait`). Called under the lock."""
    if wait and _PENDING:
        torch.cuda.synchronize()
    while _PENDING and (wait or _PENDING[0][2].query()):
        name, start, end = _PENDING.popleft()
        _STATS[name][2] += start.elapsed_time(end) * 1e-3


def count(name: str, n) -> None:
    """Add `n` (an int, or a 0-d tensor, added on its device) to a counter."""
    if not _ON:
        return
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict[str, int]:
    """Every counter's value (waits for the device where a counter lives
    there)."""
    with _LOCK:
        return {k: int(v) for k, v in _COUNTS.items()}


def spans() -> dict[str, dict]:
    """Per span name: calls, host seconds and device seconds (waits for
    the device to read every pending span)."""
    with _LOCK:
        _resolve(wait=True)
        return {k: {"calls": c, "host_s": h, "device_s": d} for k, (c, h, d) in _STATS.items()}


def time_block(name: str):
    """The reference's name for a span used as a context manager."""
    return span(name)


def time_function(fn=None, *, name: Optional[str] = None):
    """The reference's decorator: the function's calls as a span under
    `name` (default: its qualified name)."""

    def deco(f):
        return span(name or f.__qualname__)(f)

    return deco(fn) if fn is not None else deco


@contextmanager
def trace(log_dir, enabled: bool = True):
    """Profile the block with torch.profiler (the CPU, and CUDA where torch
    sees a card) and write its Chrome trace to `log_dir`/trace.json (view
    it in Perfetto or chrome://tracing)."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def summary() -> str:
    lines = ["profiler summary (mean over calls; device: the span's CUDA events):"]
    for name, s in sorted(spans().items(), key=lambda kv: -kv[1]["host_s"]):
        c = max(s["calls"], 1)
        lines.append(f"  {name}: host {s['host_s'] / c * 1e3:.2f} ms, device {s['device_s'] / c * 1e3:.2f} ms "
                     f"x {s['calls']}")
    for name, v in sorted(counters().items()):
        lines.append(f"  {name}: {v}")
    return "\n".join(lines)


@atexit.register
def _print_summary():
    if _STATS or _COUNTS:
        print(summary(), file=sys.stderr, flush=True)
