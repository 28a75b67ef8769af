"""hash_emitter_ms_per_step: the device time of every activity launched
inside the port's spans `emitter.forward` (each emitter call of the
renderer, the checkpoint's second pass included) and `emitter.backward`
(the emitter query's backward: for the frozen hash field, the chunked
recompute through the model's forward, K7 encoding) in the traced guiding
period, over its steps, in ms. None where the program has neither span or
the run saw no device activity."""

SPANS = ("emitter.forward", "emitter.backward")


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("steps"):
        return None
    spans = r.get("program_spans") or {}
    if not any(k in spans for k in SPANS):
        return None
    return 1e3 * sum(spans[k]["device_s"] for k in SPANS if k in spans) / r["steps"]
