"""idle_share.takeover: the share of one traced guiding period (a rebuild
and its steps) in which no device activity ran, in %."""


def read(r):
    if r.get("kind") != "takeover" or not r.get("device_events") or not r.get("window_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
