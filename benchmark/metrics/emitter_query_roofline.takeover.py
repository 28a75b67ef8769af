"""emitter_query_roofline.takeover: the least time of the emitter query's
work in the traced period (the rays asked of the emitter closure times the
configured schedule's FLOPs, forward plus twice forward for rays with a
gradient, against the rays' bytes; whichever bounds) over the device time
of every activity launched inside the emitter spans and inside the kernel
query's backward (_MegaQueryBackward), in %."""


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("emitter_device_s"):
        return None
    return 100.0 * r["emitter_bound_s"] / r["emitter_device_s"]
