"""The share of LPIPS's VGG convolutions whose bias, ReLU and pool ran in
a launch of the program's fused epilogue kernel: `lpips_epilogues /
lpips_convs` of `step_totals` over the window's steps (1.0 when every
layer took the fused kernels). None where the program counts neither."""
from harness.spans import step_mean


def read(rec):
    try:
        epilogues = step_mean(rec, "lpips_epilogues")
        convs = step_mean(rec, "lpips_convs")
    except KeyError:            # a recorder without the counters
        return None
    return epilogues / convs if epilogues is not None and convs else None
