"""sdf_step_ms: the SDF train step's time (a span around the pipeline's step
function, on the device's clock by CUDA events) per step of the traced
period, in ms."""


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("steps"):
        return None
    return 1e3 * r["sdf_step_s"] / r["steps"]
