"""sdf_step_idle_ms_per_step: the time the device was idle while the port's
span `takeover.sdf_step` (the SDF train step) was open on the host, in the
traced guiding period, over its steps, in ms."""


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("steps"):
        return None
    s = (r.get("program_spans") or {}).get("takeover.sdf_step")
    if s is None:
        return None
    return 1e3 * s["idle_s"] / r["steps"]
