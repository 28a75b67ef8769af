"""hash_encoding_ms_per_step: the device time of every activity launched
inside the port's spans `encoding.forward` and `encoding.backward` (the
hash grid's forward and its backward, K7 on the card) in the traced
window, over its steps, in ms. None where the program has neither span
(a program without them) or the run saw no device activity."""

SPANS = ("encoding.forward", "encoding.backward")


def read(r):
    if r.get("kind") != "pretrain" or not r.get("device_events") or not r.get("steps"):
        return None
    spans = r.get("program_spans") or {}
    if not any(k in spans for k in SPANS):
        return None
    return 1e3 * sum(spans[k]["device_s"] for k in SPANS if k in spans) / r["steps"]
