"""mfu.takeover: the FLOPs of every MLP evaluation the traced guiding period
asked for (the emitter's rays, forward once and backward twice where they
carry a gradient, no recomputation; the guiding's probe rays, forward and
the jvp's tangent) over the window's seconds at the bf16 dense peak, in %."""


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("window_s"):
        return None
    return 100.0 * r["flops"] / (r["window_s"] * r["peak_flops"])
