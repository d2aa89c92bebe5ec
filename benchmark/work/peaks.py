"""The chip's peaks (`peaks.json`) and the least time some work can take
on it."""
from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)
FP32 = float(PEAKS["fp32_flops_per_s"])
HBM = float(PEAKS["hbm_bytes_per_s"])


def bound_s(flops: float, nbytes: float) -> float:
    """The larger of the operations over the float32 peak and the bytes
    over the bandwidth peak."""
    return max(flops / FP32, nbytes / HBM)
