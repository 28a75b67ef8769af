"""hash_encoding_roofline.pretrain: the least time of the hash grid's work
in the traced window (`encoding_bytes`: positions in and features out a
forward, each table read once a forward and its gradient written once a
backward, at HBM's rate) over the device time of every activity launched
inside the port's spans `encoding.forward` and `encoding.backward`, in %.
None where the program has neither span, the run saw no device activity
or the configuration reads no table."""

from benchmark.roofline import H100_BYTES_PER_S

SPANS = ("encoding.forward", "encoding.backward")


def read(r):
    if r.get("kind") != "pretrain" or not r.get("device_events") or not r.get("encoding_bytes"):
        return None
    spans = r.get("program_spans") or {}
    device_s = sum(spans[k]["device_s"] for k in SPANS if k in spans)
    if device_s <= 0.0:
        return None
    return 100.0 * r["encoding_bytes"] / H100_BYTES_PER_S / device_s
