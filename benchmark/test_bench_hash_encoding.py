"""The readers of the hash-grid encoding's layer
(`benchmark/metrics/hash_encoding_ms_per_step.py`,
`hash_encoding_roofline.pretrain.py`): nothing to read (a CPU run, another
cell's reading, a program without the spans `encoding.forward` and
`encoding.backward`) gives None; a reading with them gives the device time
per step and the least time of the encoding's bytes over it."""

import pytest

from benchmark import roofline, run

READERS = ("hash_encoding_ms_per_step", "hash_encoding_roofline.pretrain")


@pytest.mark.parametrize("name", READERS)
def test_the_readers_return_none_without_their_inputs(name):
    base = {"kind": "pretrain", "device_events": 40, "steps": 8, "encoding_bytes": 4.152e9,
            "program_spans": {"nerf.step": {"host_s": 1.0, "device_s": 0.9, "idle_s": 0.0}}}
    for reading in ({}, base, dict(base, device_events=0), dict(base, kind="takeover"),
                    dict(base, program_spans={"encoding.forward": {"host_s": 0.1, "device_s": 0.0, "idle_s": 0.0}},
                         device_events=0)):
        assert run.read_metric(name, reading) is None


def test_the_readers_read_their_inputs():
    spans = {"encoding.forward": {"host_s": 0.2, "device_s": 0.016, "idle_s": 0.0},
             "encoding.backward": {"host_s": 0.3, "device_s": 0.024, "idle_s": 0.0}}
    r = {"kind": "pretrain", "device_events": 40, "steps": 8, "program_spans": spans, "encoding_bytes": 4.152e9}
    assert run.read_metric("hash_encoding_ms_per_step", r) == pytest.approx(5.0)
    assert run.read_metric("hash_encoding_roofline.pretrain", r) == pytest.approx(
        100.0 * 4.152e9 / roofline.H100_BYTES_PER_S / 0.040)
    assert run.read_metric("hash_encoding_roofline.pretrain", dict(r, encoding_bytes=0)) is None
