"""The whole frame's share of the float32 peak: a frame's operations
(`work/`: the compositor, TimeNet, its share of the sequence's KNN) over
the traced window's time a frame (%)."""
from work.peaks import FP32


def read(rec):
    s, w = rec.get("serve"), rec.get("work")
    if rec["device"] != "cuda" or not s or not w or "frame_flops" not in w:
        return None
    return 100.0 * w["frame_flops"] / (s["window_s"] / s["frames"] * FP32)
