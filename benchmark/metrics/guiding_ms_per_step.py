"""guiding_ms_per_step: the guiding rebuild's time (a span around
NerfEmitterPipeline.build_emitter_proposal, on the device's clock by CUDA
events) summed over the traced period and divided by its steps, in ms."""


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("steps"):
        return None
    return 1e3 * r["guiding_s"] / r["steps"]
