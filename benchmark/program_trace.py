"""The reading of the port's own spans in a torch.profiler trace.

The port's tracing (`nerf_emitter_tpu_torch/utils/profiler.py`, switched on
around a traced period by `drivers/port_trace.port_tracing`) opens a host
range `nek::<span>` at each of its stages. `read_program_trace` reads them
beside `trace.read_trace`, on the same profile and with the same sorting of
its events:

- `program_spans`: for each port span, its host seconds (summed over its
  ranges), the device seconds of the activities launched inside its ranges
  (by the profiler's link between a device activity and the runtime call
  that launched it, on the range's thread), and the seconds the device was
  idle while one of its ranges was open on the host (the union of its
  ranges, so nested or concurrent calls count once);
- `idle_gaps`: the longest gaps of the device's timeline, each named by the
  innermost span of either prefix (`nek::` or the benchmark's own
  `bench::`) open at the gap's start, else "host", and the activity that
  ends it.

A range's mirror on the device's timeline, of either prefix, is no device
work and is left out of busy time.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from .trace import SPAN_PREFIX, _ns

PORT_PREFIX = "nek::"
PREFIXES = (PORT_PREFIX, SPAN_PREFIX)


def _sorted_events(prof):
    """The profile's events as (device activities, host ranges, runtime
    calls), sorted as `trace.read_trace` sorts them."""
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


def read_program_trace(prof, top: int = 10) -> dict:
    """From a finished profile: {"program_spans": {span: {"host_s",
    "device_s", "idle_s"}}, "idle_gaps": [[name, seconds], ...], "idle_s"
    (the window's), "window_s"} (the spans and gaps empty where the
    profile has no device activity)."""
    dev, host, runtime = _sorted_events(prof)
    starts = [_ns(e, "start") for e in host + dev]
    if not dev or not starts:
        return {"program_spans": {}, "idle_gaps": [], "idle_s": 0.0, "window_s": 0.0}
    start = min(starts)
    end = max(_ns(e, "start") + e.duration_ns() for e in host + dev)
    # the device's idle intervals inside the window, and its gaps
    idle, gaps, reach = [], [], start
    for e in dev:
        s, d = _ns(e, "start"), e.duration_ns()
        if s > reach:
            idle.append((reach, s))
            gaps.append((s - reach, reach, e.name()))
        reach = max(reach, s + d)
    if end > reach:
        idle.append((reach, end))
    # the ranges of both prefixes, innermost first at any instant
    ranges = []
    for e in host:
        name = e.name()
        if name.startswith(PREFIXES):
            s = _ns(e, "start")
            ranges.append((s, s + e.duration_ns(), name, e.start_thread_id()))

    def open_span(t):
        best = None
        for s, f, n, _ in ranges:
            if s <= t < f and (best is None or s > best[0]):
                best = (s, n)
        return best[1].split("::", 1)[1] if best else "host"

    gaps.sort(reverse=True)
    idle_gaps = [[f"{open_span(at)} -> {name.split('(')[0][:60]}", g * 1e-9] for g, at, name in gaps[:top]]

    # device time launched inside each port range, by correlation id
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
    host_ns, corr, opened = defaultdict(int), defaultdict(set), defaultdict(list)
    for s, f, name, tid in ranges:
        if not name.startswith(PORT_PREFIX):
            continue
        key = name[len(PORT_PREFIX):]
        host_ns[key] += f - s
        opened[key].append((s, f))
        rts = rt_by_tid.get(tid, [])
        i = bisect.bisect_left(rts, (s, -1))
        while i < len(rts) and rts[i][0] <= f:
            corr[key].add(rts[i][1])
            i += 1
    spans = {k: {"host_s": host_ns[k] * 1e-9,
                 "device_s": sum(by_corr.get(c, 0) for c in corr[k]) * 1e-9,
                 "idle_s": sum(_overlap(idle, s, f) for s, f in _union(opened[k])) * 1e-9}
             for k in sorted(host_ns)}
    idle_s = sum(f - s for s, f in idle) * 1e-9
    return {"program_spans": spans, "idle_gaps": idle_gaps, "idle_s": idle_s, "window_s": (end - start) * 1e-9}
