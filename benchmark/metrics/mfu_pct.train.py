"""The whole step's share of the float32 peak: a step's operations
(`work/`: LPIPS, the compositor both ways, TimeNet, the KNN) over the
traced window's time a step (%)."""
from work.peaks import FP32


def read(rec):
    t, w = rec.get("train"), rec.get("work")
    if rec["device"] != "cuda" or not t or not w or "step_flops" not in w:
        return None
    return 100.0 * w["step_flops"] / (t["window_s"] / t["steps"] * FP32)
