"""emitter_used_share: the share of the emitter's answers (the rows asked of
the port's span `emitter.forward` outside a backward, `emitter.rays`) that
the estimate keeps (`emitter.used_rays`: hit and visible for the surface
terms, escaped for the miss term), in the traced guiding period, in %."""


def read(r):
    if r.get("kind") != "takeover":
        return None
    c = r.get("program_counts") or {}
    if not c.get("emitter.rays"):
        return None
    return 100.0 * c.get("emitter.used_rays", 0) / c["emitter.rays"]
