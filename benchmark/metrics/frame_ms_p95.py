"""The 95th percentile, over all frames of the window, of the interval
from the previous frame's delivery to a frame's own (ms, nearest rank)."""
import math


def read(rec):
    s = rec.get("serve")
    if not s or not s["intervals"]:
        return None
    v = sorted(s["intervals"])
    return 1000.0 * v[max(0, math.ceil(0.95 * len(v)) - 1)]
