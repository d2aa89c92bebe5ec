"""K1's share of its roofline in the profiled sequence: the least time
the chip needs for those frames' 7-channel composites, counted on the
reference's own strip lists (`work/compositor.py`), over the device time
of `composite_fwd_kernel` (%)."""
from harness.trace import kernel_seconds
from work.peaks import bound_s


def read(rec):
    t, w = rec.get("trace"), rec.get("work")
    if not t or not w or not w.get("k1"):
        return None
    spent = kernel_seconds(t["by_name"], ("composite_fwd_kernel",))
    if spent <= 0:
        return None
    return 100.0 * sum(bound_s(*x) for x in w["k1"]) / spent
