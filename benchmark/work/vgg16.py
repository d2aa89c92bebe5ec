"""LPIPS-VGG16: the multiply-adds of its thirteen 3x3 convolutions (SAME
padding, a 2x2 max-pool before convolutions 2, 4, 7 and 10), counted
from shapes. Biases, ReLUs, pools and the LPIPS heads are left out (well
under 1% of the operations)."""
from __future__ import annotations

PLAN = [(64, False), (64, False), (128, True), (128, False), (256, True),
        (256, False), (256, False), (512, True), (512, False), (512, False),
        (512, True), (512, False), (512, False)]


def conv_macs(height: int, width: int) -> int:
    """Multiply-adds of one image's forward through the 13 convolutions."""
    total, c_in, h, w = 0, 3, height, width
    for c_out, pool in PLAN:
        if pool:
            h, w = h // 2, w // 2
        total += h * w * c_in * c_out * 9
        c_in = c_out
    return total


def lpips_step_flops(n_images: int, height: int, width: int) -> float:
    """float32 operations of LPIPS in a train step: both towers' forward
    and the rendered tower's input gradient (the weights are not
    trained), 2 operations a multiply-add."""
    return 3.0 * n_images * 2.0 * conv_macs(height, width)
