"""The reading of the port's spans (`trace.read_trace`) on a synthetic
profile, and the readers of the metrics it feeds: a gap is named
by the innermost span open at its start, a range's mirror on the device's
timeline is no device work, the idle while a span is open is no more than
the window's, device time is linked to the span that launched it on its
own thread, and each reader returns None where its inputs are absent.

    python -m pytest benchmark/ -q
"""

import types

import pytest

from benchmark import run, trace

NS = 1e-9


class Event:
    """The fields of a profiler event that the readings use."""

    def __init__(self, name, start, dur, device="CPU", kind="", tid=1, corr=0):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._kind, self._tid, self._corr = device, kind, tid, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return f"DeviceType.{self._device}"

    def activity_type(self):
        return self._kind

    def start_thread_id(self):
        return self._tid

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0


def _profile(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def _launch(at, corr, tid=1):
    return Event("cudaLaunchKernel", at, 5, kind="cuda_runtime", tid=tid, corr=corr)


def _kernel(name, start, dur, corr):
    return Event(name, start, dur, device="CUDA", kind="kernel", corr=corr)


# a step on the host (thread 1) with the emitter's backward on autograd's
# thread (2); four kernels; the device idle over [0, 100), [200, 450),
# [480, 520), [560, 700) and [780, 1000): 750 ns of the 1,000 ns window
EVENTS = [
    Event("bench::sdf_step", 0, 1000),
    Event("nek::takeover.sdf_step", 10, 980),
    Event("nek::sdf.band_forward", 20, 380),
    Event("nek::sdf.band_backward", 400, 500),
    Event("nek::emitter.backward", 500, 300, tid=2),
    _launch(30, 1), _launch(410, 2), _launch(510, 3, tid=2), _launch(600, 4, tid=2),
    _kernel("k1", 100, 100, 1), _kernel("k2", 450, 30, 2), _kernel("k3", 520, 40, 3),
    _kernel("k4(float)", 700, 80, 4),
    # the ranges' mirrors on the device's timeline: no device work
    Event("nek::sdf.band_backward", 400, 500, device="CUDA"),
    Event("bench::sdf_step", 0, 1000, device="CUDA", kind="gpu_user_annotation"),
]


@pytest.fixture(scope="module")
def read():
    return trace.read_trace(_profile(EVENTS))


def test_gaps_are_named_by_the_innermost_open_span(read):
    assert read["idle_gaps"] == [["sdf.band_forward -> k2", pytest.approx(250 * NS)],
                                 ["emitter.backward -> k4", pytest.approx(140 * NS)],
                                 ["sdf_step -> k1", pytest.approx(100 * NS)],
                                 ["sdf.band_backward -> k3", pytest.approx(40 * NS)]]


def test_mirrors_are_no_device_work(read):
    """With the band's mirror counted as busy, the device would never be
    idle while the band's backward is open."""
    assert read["idle_s"] == pytest.approx(750 * NS) and read["window_s"] == pytest.approx(1000 * NS)
    assert read["program_spans"]["sdf.band_backward"]["idle_s"] == pytest.approx(350 * NS)


def test_spans_device_and_idle_seconds(read):
    spans = read["program_spans"]
    assert set(spans) == {"takeover.sdf_step", "sdf.band_forward", "sdf.band_backward", "emitter.backward"}
    want = {"takeover.sdf_step": (980, 130, 730), "sdf.band_forward": (380, 100, 280),
            "sdf.band_backward": (500, 30, 350), "emitter.backward": (300, 120, 180)}
    for k, (host, dev, idle) in want.items():
        assert spans[k] == {"host_s": pytest.approx(host * NS), "device_s": pytest.approx(dev * NS),
                            "idle_s": pytest.approx(idle * NS)}, k


def test_idle_while_open_is_no_more_than_the_windows(read):
    spans = read["program_spans"]
    assert all(s["idle_s"] <= read["idle_s"] for s in spans.values())
    assert spans["sdf.band_forward"]["idle_s"] + spans["sdf.band_backward"]["idle_s"] <= read["idle_s"]


def test_nested_and_concurrent_ranges_of_a_span_count_their_idle_once():
    events = EVENTS + [Event("nek::sdf.band_forward", 50, 100), Event("nek::sdf.band_forward", 60, 300, tid=3)]
    spans = trace.read_trace(_profile(events))["program_spans"]
    assert spans["sdf.band_forward"]["idle_s"] == pytest.approx(280 * NS)
    assert spans["sdf.band_forward"]["host_s"] == pytest.approx(780 * NS)


def test_a_profile_without_device_work_reads_empty():
    """No device activity (a CPU run): no gap, no device or idle time; the
    spans' host seconds alone are read."""
    got = trace.read_trace(_profile([e for e in EVENTS if e.device_type() != "DeviceType.CUDA"]))
    assert got["idle_gaps"] == [] and got["device_events"] == 0 and got["busy_s"] == got["idle_s"] == 0
    assert {k: s["host_s"] for k, s in got["program_spans"].items()} == {
        "takeover.sdf_step": pytest.approx(980 * NS), "sdf.band_forward": pytest.approx(380 * NS),
        "sdf.band_backward": pytest.approx(500 * NS), "emitter.backward": pytest.approx(300 * NS)}
    assert all(s["device_s"] == s["idle_s"] == 0 for s in got["program_spans"].values())


PORT_READERS = ("emitter_backward_ms_per_step", "emitter_used_share", "sdf_step_idle_ms_per_step",
                "guiding_idle_ms_per_step")


@pytest.mark.parametrize("name", PORT_READERS)
def test_port_readers_return_none_without_their_inputs(name):
    base = {"kind": "takeover", "device_events": 4, "steps": 10, "window_s": 1.0}
    for reading in ({}, base, dict(base, kind="pretrain", program_spans={}, program_counts={}),
                    dict(base, program_spans={}, program_counts={"emitter.rays": 0})):
        assert run.read_metric(name, reading) is None


def test_port_readers_read_their_inputs():
    spans = {"emitter.backward": {"host_s": 9.0, "device_s": 7.5, "idle_s": 0.5},
             "takeover.sdf_step": {"host_s": 13.0, "device_s": 11.0, "idle_s": 3.0},
             "takeover.guiding": {"host_s": 4.2, "device_s": 1.0, "idle_s": 2.0}}
    r = {"kind": "takeover", "device_events": 4, "steps": 10, "program_spans": spans,
         "program_counts": {"emitter.rays": 400, "emitter.used_rays": 100}}
    assert run.read_metric("emitter_backward_ms_per_step", r) == pytest.approx(750.0)
    assert run.read_metric("sdf_step_idle_ms_per_step", r) == pytest.approx(300.0)
    assert run.read_metric("guiding_idle_ms_per_step", r) == pytest.approx(200.0)
    assert run.read_metric("emitter_used_share", r) == pytest.approx(25.0)


def test_tracing_cost_runs_tiny_on_the_cpu(capsys):
    """`python -m benchmark.tracing_cost` on the K5 takeover at its tiny size,
    set up to a rebuild step, one period off and one on: a line a period,
    the port's counters equal to the wrappers' counts with tracing on and
    empty with it off (a CPU run reads no device metric)."""
    import json

    from benchmark import tracing_cost
    from benchmark.test_bench_cells import tiny

    cell = "sdf-nerfacto-k5.takeover"
    sizes = tiny(cell)
    sizes["traffic"]["window_step"] = 70
    assert tracing_cost.main(["--workload", cell, "--seed", "3000000003", "--port", "0,1"], device="cpu",
                             overrides=sizes) == 0
    rows = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith('{"workload"')]
    assert [r["port"] for r in rows] == [0, 1]
    off, on = rows
    assert off["program_counts"] == {} and all(port == 0 for _, port in off["counts"].values())
    assert all(wrappers == port > 0 for wrappers, port in on["counts"].values())
    assert set(PORT_READERS) <= set(on["metrics"])
    assert on["metrics"]["emitter_used_share"] > 0 and off["metrics"]["emitter_used_share"] is None
    assert all(on["metrics"][k] is None for k in PORT_READERS if k != "emitter_used_share")
