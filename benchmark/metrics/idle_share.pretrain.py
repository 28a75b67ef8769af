"""idle_share.pretrain: the share of the traced pretraining window in which
no device activity ran, in %."""


def read(r):
    if r.get("kind") != "pretrain" or not r.get("device_events") or not r.get("window_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
