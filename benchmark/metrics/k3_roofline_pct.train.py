"""K3's share of its roofline in the profiled steps: the least time the
chip needs for the backward composites of those renders, counted on the
reference's own strip lists (`work/compositor.py`), over the device time
of `composite_bwd_kernel` and `combine_groups_kernel` (%)."""
from harness.trace import kernel_seconds
from work.peaks import bound_s


def read(rec):
    t, w = rec.get("trace"), rec.get("work")
    if not t or not w or not w.get("k3"):
        return None
    spent = kernel_seconds(t["by_name"], ("composite_bwd_kernel",
                                          "combine_groups_kernel"))
    if spent <= 0:
        return None
    return 100.0 * sum(bound_s(*x) for x in w["k3"]) / spent
