"""The traced run's instruments: benchmark-side spans around calls into the
program's layers, and the reading of a torch.profiler trace.

`Spans` wraps methods and functions of the program while entered, as the
port's `scripts/profiling.Stages` does, but never synchronises the device:
each call gets a `record_function` range (named `bench::<span>`) that the
trace reads, a pair of CUDA events whose gap is the span's time on the
device's clock, and any counts its `count` callback returns. The events
are read once the window has closed.

`read_trace` is the arithmetic of the port's `scripts/profiling.device_trace`
(busy time as the union of device activities, idle gaps and the activity
that ends each, device time by kernel name) on the profiler's own events
rather than an exported chrome trace, plus the device time of the
activities that host ranges launched, by the profiler's link between a
device activity and the runtime call that launched it.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "bench::"


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
def profiled(cuda: bool):
    """A torch.profiler over the block (device activities where there is a
    card); yields a holder whose `prof` is the finished profile."""
    holder = type("Profile", (), {})()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    holder.prof = prof


def _ns(e, attr: str) -> int:
    fn = getattr(e, attr + "_ns", None)
    return fn() if fn is not None else getattr(e, attr + "_us")() * 1000


def read_trace(prof, linked_ranges=(), top: int = 10) -> dict:
    """From a finished profile: window_s (first event to last), busy_s (the
    union of device activities), idle_share, device_ops (the `top` device
    activities by summed seconds), idle_gaps (the `top` longest gaps, each
    named by the bench span open on the launching thread at the gap's start,
    else "host", and the device activity that ends it), spans (seconds of
    each bench:: range on the host), and for each entry of `linked_ranges`
    (a predicate on a host range's name) the device seconds of the
    activities launched inside the matching ranges."""
    events = prof.profiler.kineto_results.events()
    dev, host, runtime = [], [], []
    for e in events:
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if str(e.device_type()).endswith("CUDA"):
            # a host range's mirror on the device's timeline is no device work
            if "annotation" not in kind and not e.name().startswith(SPAN_PREFIX):
                dev.append(e)
        elif kind in ("cuda_runtime", "cuda_driver") or (
                not kind and e.name().startswith(("cuda", "cu")) and not e.name().startswith("cudnn")):
            runtime.append(e)
        else:
            host.append(e)
    dev.sort(key=lambda e: _ns(e, "start"))
    starts = [_ns(e, "start") for e in host + dev]
    ends = [_ns(e, "start") + e.duration_ns() for e in host + dev]
    if not dev or not starts:
        return {"window_s": (max(ends) - min(starts)) * 1e-9 if starts else 0.0, "busy_s": 0.0,
                "device_events": 0}
    start, end = min(starts), max(ends)
    busy, reach, gaps, per_name = 0, start, [], defaultdict(int)
    for e in dev:
        s, d = _ns(e, "start"), e.duration_ns()
        if s > reach:
            gaps.append((s - reach, reach, e.name()))
        busy += max(0, s + d - max(s, reach))
        reach = max(reach, s + d)
        per_name[e.name().split("(")[0].split("<")[0][:80]] += d
    # the bench spans on each thread, for naming gaps and linking launches
    spans_by_tid = defaultdict(list)
    span_s = defaultdict(float)
    for e in host:
        if e.name().startswith(SPAN_PREFIX):
            s = _ns(e, "start")
            spans_by_tid[e.start_thread_id()].append((s, s + e.duration_ns(), e.name()[len(SPAN_PREFIX):]))
            span_s[e.name()[len(SPAN_PREFIX):]] += e.duration_ns() * 1e-9

    def open_span(t):
        best = None
        for spans in spans_by_tid.values():
            for s, f, n in spans:
                if s <= t < f and (best is None or s > best[0]):
                    best = (s, n)
        return best[1] if best else "host"

    gaps.sort(reverse=True)
    idle_gaps = [[f"{open_span(at)} -> {name.split('(')[0][:60]}", g * 1e-9] for g, at, name in gaps[:top]]
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])
    out = {"window_s": (end - start) * 1e-9, "busy_s": busy * 1e-9, "device_events": len(dev),
           "device_ops": [[k, v * 1e-9] for k, v in ranked[:top]], "idle_gaps": idle_gaps,
           "spans": dict(span_s), "linked_s": []}
    if linked_ranges:
        # a device activity names its launch by the runtime call's
        # correlation id, in one field or the other as torch versions differ
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
        for pred in linked_ranges:
            corr = set()
            for e in host:
                if not pred(e.name()):
                    continue
                s, f = _ns(e, "start"), _ns(e, "start") + e.duration_ns()
                rts = rt_by_tid.get(e.start_thread_id(), [])
                i = bisect.bisect_left(rts, (s, -1))
                while i < len(rts) and rts[i][0] <= f:
                    corr.add(rts[i][1])
                    i += 1
            out["linked_s"].append(sum(by_corr.get(c, 0) for c in corr) * 1e-9)
    return out
