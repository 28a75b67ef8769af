"""hash_emitter_roofline.takeover: the least time of the NeRF's work that
the traced guiding period asked for (the larger of its `flops` at the bf16
peak and its `encoding_bytes` at HBM's rate: the emitter's rays, forward
once and backward twice where they carry a gradient, and the guiding's
probe rays, forward and the jvp's tangent; the tables read once) over the
device time of every activity launched inside the port's spans
`emitter.forward`, `emitter.backward` and `guiding.probes`, which hold the
same rays, in %. None where the program has none of the spans or the run
saw no device activity."""

from benchmark.roofline import bound_s

SPANS = ("emitter.forward", "emitter.backward", "guiding.probes")


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("flops"):
        return None
    spans = r.get("program_spans") or {}
    device_s = sum(spans[k]["device_s"] for k in SPANS if k in spans)
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s(r["flops"], r.get("encoding_bytes", 0))[0] / device_s
