"""LPIPS's share of its roofline in the profiled steps: the least time
the chip needs for the float32 operations of LPIPS's forward through
both towers over those steps (`work/vgg16.py`), over the device's busy
time in their `lpips` segments (%)."""
from work.peaks import bound_s


def read(rec):
    t, w = rec.get("trace"), rec.get("work")
    seg = ((t or {}).get("by_segment") or {}).get("lpips")
    if not seg or not w or not w.get("lpips_flops") or seg["busy_s"] <= 0:
        return None
    return 100.0 * bound_s(w["lpips_flops"], 0.0) / seg["busy_s"]
