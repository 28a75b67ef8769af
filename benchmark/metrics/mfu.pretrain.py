"""mfu.pretrain: the NeRF pretraining step's model FLOPs (the configuration's
widths at the configuration's samples, forward once and backward twice, no
recomputation) over the traced window's seconds at the bf16 dense peak, in %."""


def read(r):
    if r.get("kind") != "pretrain" or not r.get("device_events") or not r.get("window_s"):
        return None
    return 100.0 * r["flops"] / (r["window_s"] * r["peak_flops"])
