"""The traced run's instruments: benchmark-side spans around calls into the
program's layers, the port's own tracing switched on over a traced period,
and the reading of a torch.profiler trace.

`Spans` wraps methods and functions of the program while entered, as the
port's `scripts/profiling.Stages` does, but never synchronises the device:
each call gets a `record_function` range (named `bench::<span>`) that the
trace reads, a pair of CUDA events whose gap is the span's time on the
device's clock, and any counts its `count` callback returns. The events
are read once the window has closed.

`profiled` runs a period under the profiler with the port's tracing
(`nerf_emitter_tpu_torch/utils/profiler.py`: host ranges `nek::<span>` and
counters) reset and on, and times the period on the host's clock.

`read_trace` is the arithmetic of the port's `scripts/profiling.device_trace`
(busy time as the union of device activities, idle gaps and the activity
that ends each, device time by kernel name) on the profiler's own events
rather than an exported chrome trace, plus the device time of the
activities that host ranges launched, by the profiler's link between a
device activity and the runtime call that launched it, and the port's
spans read from the same events.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
import types
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import program

SPAN_PREFIX = "bench::"  # the benchmark's own wrappers (`Spans`)
PORT_PREFIX = "nek::"  # the port's spans
PREFIXES = (PORT_PREFIX, SPAN_PREFIX)


class Spans:
    """While entered, wraps `owner.attr` callables. Per span name: the
    calls' CUDA-event pairs and summed counts."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.events: dict[str, list] = defaultdict(list)
        self.counts: dict[str, dict] = defaultdict(lambda: defaultdict(float))
        self._undo = []

    def wrap(self, owner, attr: str, name: str, count=None, wrap_result=None) -> None:
        """count(args, kwargs) -> {counter: value} is added up per call;
        wrap_result(out) replaces what the call returns (for a factory of
        closures whose calls are spans of their own)."""
        real = getattr(owner, attr)
        setattr(owner, attr, self.wrapped(real, name, count, wrap_result))
        self._undo.append((owner, attr, real))

    def wrapped(self, fn, name: str, count=None, wrap_result=None):
        spans = self

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if count is not None:
                for k, v in count(args, kwargs).items():
                    spans.counts[name][k] += v
            marks = None
            if spans.cuda:
                marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                marks[0].record()
            with record_function(SPAN_PREFIX + name):
                out = fn(*args, **kwargs)
            if marks is not None:
                marks[1].record()
                spans.events[name].append(marks)
            return wrap_result(out) if wrap_result is not None else out

        return call

    def seconds(self, name: str) -> float:
        """The span's summed time on the device's clock (0 on the CPU)."""
        if self.cuda:
            torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events.get(name, [])) * 1e-3

    def __enter__(self) -> "Spans":
        return self

    def __exit__(self, *exc) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()


@contextlib.contextmanager
def profiled(cuda: bool, port: bool = True):
    """A torch.profiler over the block (device activities where there is a
    card), with the port's tracing reset and on over it where `port`;
    yields a holder whose `prof` (the finished profile), `counts` (the
    port's counters, empty with `port` off) and `period_s` (the block's
    host seconds, ending in a synchronise) are set once it has closed."""
    holder = types.SimpleNamespace()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with program.port_tracing(port) as counts, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield holder
        if cuda:
            torch.cuda.synchronize()
        holder.period_s = time.perf_counter() - t0
    holder.prof, holder.counts = prof, counts


def read_period(holder, linked_ranges=()) -> dict:
    """A `profiled` period's reading: `read_trace` of its profile, the
    port's counters (`program_counts`) and the period's host seconds
    (`period_s`)."""
    return dict(read_trace(holder.prof, linked_ranges), program_counts=holder.counts, period_s=holder.period_s)


def _ns(e, attr: str) -> int:
    fn = getattr(e, attr + "_ns", None)
    return fn() if fn is not None else getattr(e, attr + "_us")() * 1000


def _kernel(name: str, width: int) -> str:
    """A device activity's name without its arguments and template
    arguments, the anonymous namespace left out first."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0][:width]


def _sorted_events(prof):
    """The profile's events as (device activities sorted by start, host
    events, runtime calls). A host range's mirror on the device's timeline,
    of either prefix, is no device work."""
    dev, host, runtime = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if str(e.device_type()).endswith("CUDA"):
            if "annotation" not in kind and not e.name().startswith(PREFIXES):
                dev.append(e)
        elif kind in ("cuda_runtime", "cuda_driver") or (
                not kind and e.name().startswith(("cuda", "cu")) and not e.name().startswith("cudnn")):
            runtime.append(e)
        else:
            host.append(e)
    dev.sort(key=lambda e: _ns(e, "start"))
    return dev, host, runtime


def _overlap(intervals: list, lo: int, hi: int) -> int:
    """The length of [lo, hi) covered by sorted, disjoint `intervals`."""
    total = 0
    i = max(0, bisect.bisect_right(intervals, (lo, lo)) - 1)
    while i < len(intervals) and intervals[i][0] < hi:
        s, f = intervals[i]
        total += max(0, min(f, hi) - max(s, lo))
        i += 1
    return total


def _union(ranges: list) -> list:
    out = []
    for s, f in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], f))
        else:
            out.append((s, f))
    return out


def read_trace(prof, linked_ranges=(), top: int = 10) -> dict:
    """From a finished profile:

    - window_s (first event to last), busy_s (the union of device
      activities), idle_s (the rest of the window), device_events;
    - device_ops: the `top` device activities by summed seconds;
    - idle_gaps: the `top` longest gaps, each named by the innermost range
      of either prefix (`nek::` or `bench::`) open at the gap's start, else
      "host", and the device activity that ends it;
    - spans: the host seconds of each `bench::` range;
    - linked_s: for each entry of `linked_ranges` (a predicate on a host
      range's name), the device seconds of the activities launched inside
      the matching ranges;
    - program_spans: for each port span (`nek::`), its host seconds (summed
      over its ranges), the device seconds launched inside its ranges (on
      the range's thread), and the seconds the device was idle while one of
      its ranges was open (the union of its ranges, so nested or concurrent
      calls count once). Without device activity (a CPU run) only the host
      seconds are read, and the device's are 0.
    """
    dev, host, runtime = _sorted_events(prof)
    ranges = []  # (start, end, name, thread) of both prefixes
    for e in host:
        if e.name().startswith(PREFIXES):
            s = _ns(e, "start")
            ranges.append((s, s + e.duration_ns(), e.name(), e.start_thread_id()))
    span_s, port_host, port_ranges = defaultdict(float), defaultdict(int), defaultdict(list)
    for s, f, name, tid in ranges:
        if name.startswith(SPAN_PREFIX):
            span_s[name[len(SPAN_PREFIX):]] += (f - s) * 1e-9
        else:
            port_host[name[len(PORT_PREFIX):]] += f - s
            port_ranges[name[len(PORT_PREFIX):]].append((s, f, tid))
    starts = [_ns(e, "start") for e in host + dev]
    ends = [_ns(e, "start") + e.duration_ns() for e in host + dev]
    window = (max(ends) - min(starts)) * 1e-9 if starts else 0.0
    if not dev:
        return {"window_s": window, "busy_s": 0.0, "idle_s": 0.0, "device_events": 0, "idle_gaps": [],
                "spans": dict(span_s), "linked_s": [0.0] * len(linked_ranges),
                "program_spans": {k: {"host_s": port_host[k] * 1e-9, "device_s": 0.0, "idle_s": 0.0}
                                  for k in sorted(port_host)}}
    start, end = min(starts), max(ends)
    busy, reach, gaps, idle, per_name = 0, start, [], [], defaultdict(int)
    for e in dev:
        s, d = _ns(e, "start"), e.duration_ns()
        if s > reach:
            gaps.append((s - reach, reach, e.name()))
            idle.append((reach, s))
        busy += max(0, s + d - max(s, reach))
        reach = max(reach, s + d)
        per_name[_kernel(e.name(), 80)] += d
    if end > reach:
        idle.append((reach, end))

    def open_span(t):
        best = None
        for s, f, n, _ in ranges:
            if s <= t < f and (best is None or s > best[0]):
                best = (s, n)
        return best[1].split("::", 1)[1] if best else "host"

    gaps.sort(reverse=True)
    idle_gaps = [[f"{open_span(at)} -> {_kernel(name, 60)}", g * 1e-9] for g, at, name in gaps[:top]]
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])

    # a device activity names its launch by the runtime call's correlation
    # id, in one field or the other as torch versions differ
    rt_ids = {e.correlation_id() for e in runtime}
    by_corr = defaultdict(int)
    for e in dev:
        c = e.correlation_id() if e.correlation_id() in rt_ids else e.linked_correlation_id()
        by_corr[c] += e.duration_ns()
    rt_by_tid = defaultdict(list)
    for e in runtime:
        rt_by_tid[e.start_thread_id()].append((_ns(e, "start"), e.correlation_id()))
    for v in rt_by_tid.values():
        v.sort()

    def launched_s(inside) -> float:
        """Device seconds launched inside the (start, end, thread) ranges."""
        corr = set()
        for s, f, tid in inside:
            rts = rt_by_tid.get(tid, [])
            i = bisect.bisect_left(rts, (s, -1))
            while i < len(rts) and rts[i][0] <= f:
                corr.add(rts[i][1])
                i += 1
        return sum(by_corr.get(c, 0) for c in corr) * 1e-9

    linked = [launched_s([(_ns(e, "start"), _ns(e, "start") + e.duration_ns(), e.start_thread_id())
                          for e in host if pred(e.name())]) for pred in linked_ranges]
    program_spans = {k: {"host_s": port_host[k] * 1e-9, "device_s": launched_s(port_ranges[k]),
                         "idle_s": sum(_overlap(idle, s, f) for s, f in _union([r[:2] for r in port_ranges[k]]))
                         * 1e-9}
                     for k in sorted(port_host)}
    return {"window_s": (end - start) * 1e-9, "busy_s": busy * 1e-9, "idle_s": sum(f - s for s, f in idle) * 1e-9,
            "device_events": len(dev), "device_ops": [[k, v * 1e-9] for k, v in ranked[:top]],
            "idle_gaps": idle_gaps, "spans": dict(span_s), "linked_s": linked, "program_spans": program_spans}
