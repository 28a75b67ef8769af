"""emitter_backward_ms_per_step: the device time of every activity launched
inside the port's span `emitter.backward` (the kernel query's backward,
`_MegaQuery.backward`: with the NeRF frozen, K3's bins and the vjp kernel)
in the traced guiding period, over its steps, in ms."""


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("steps"):
        return None
    s = (r.get("program_spans") or {}).get("emitter.backward")
    if s is None:
        return None
    return 1e3 * s["device_s"] / r["steps"]
