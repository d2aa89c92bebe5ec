"""The strip compositor's work per render (kernels K1 forward and K3
backward), as `chip_smoke.py` counts it: every (pixel, list entry) pair
of a strip is walked (the 7-channel variant never stops early), the
power is formed at each (16 float32 operations), and the rest only where
alpha > 0 (K1: 5 more and 2 a channel; K3: 49 more). Each table row and
list entry is read once and each plane written once."""
from __future__ import annotations

OPS_POWER = 16
K1_OPS_BASE = 21
K3_OPS = 65


def k1(pairs: int, live: int, entries: int, table_rows: int, strips: int,
       height: int, width: int, channels: int = 7) -> tuple:
    """(operations, bytes) of one forward composite."""
    ops = pairs * OPS_POWER + live * (K1_OPS_BASE - OPS_POWER + 2 * channels)
    nbytes = (table_rows * 16 * 4 + entries * 4 + strips * 4
              + (channels + 1) * height * width * 4)
    return float(ops), float(nbytes)


def k3(pairs: int, live: int, entries: int, list_slots: int, strips: int,
       height: int, width: int) -> tuple:
    """(operations, bytes) of one backward composite: the entries' rows
    read and their gradients written (64 + 4 bytes each), the eight
    cotangent planes and T_final read, and the slots' gradient rows."""
    ops = pairs * OPS_POWER + live * (K3_OPS - OPS_POWER)
    nbytes = (entries * (64 + 4) + strips * 4 + 9 * height * width * 4
              + list_slots * 16 * 4)
    return float(ops), float(nbytes)
