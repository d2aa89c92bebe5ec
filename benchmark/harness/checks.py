"""The comparisons that decide `correct`, each number beside its limit.

Training: the loss of the first step, the norm of the first gradient as
the optimizer got it, and the norm of each leaf's change after the first
steps, program against reference, the last two by the worst leaf:
the gap between the two norms over the reference's norm of that leaf or
of the median leaf, whichever is larger. A leaf whose first gradient in
the reference is under a thousandth of the median leaf's moves under
Adam by round-off alone and is left out of the change. The batches the
program drew must be the reference's, row for row and byte for byte.

Serving: the widest gap, in levels of the uint8 frame, between a
delivered frame and the reference's, and the share of pixels more than
one level apart.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch


def norms(leaves: dict) -> dict:
    """{leaf: L2 norm} of the non-empty leaves, in float64."""
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in leaves.items() if v.numel()}


def worst_leaf(prog: dict, ref: dict, keys) -> tuple:
    """(largest relative gap, its leaf) over `keys`."""
    keys = [k for k in keys if k in ref]
    if not keys:
        return 0.0, None
    med = statistics.median(ref[k] for k in keys)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog / ref: {"losses": [...], "grad": {leaf: norm}, "change":
    {leaf: norm}}; returns {number: (value, detail)}. The later steps'
    losses are given (`loss_gap_later`) and not compared: a Gaussian at
    the binning's cut (a strip's capacity, the nearest 2,048 of the
    medium tier) enters or leaves a render on a rounding of its depth
    once the two sides' parameters have parted by an Adam step."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    grad_gap, grad_leaf = worst_leaf(prog["grad"], ref["grad"], ref["grad"])
    med_g = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= 1e-3 * med_g]
    frozen = [k for k, c in ref["change"].items() if c == 0.0]
    counted = [k for k in moving if ref["change"].get(k, 0.0) > 0.0]
    chg_gap, chg_leaf = worst_leaf(prog["change"], ref["change"], counted)
    # a leaf the reference keeps still (learning rate 0) must not move
    still = max((prog["change"].get(k, 0.0) for k in frozen), default=0.0)
    return {"loss_gap": (gaps[0], None),
            "loss_gap_later": (max(gaps[1:], default=0.0), None),
            "grad_gap": (grad_gap, grad_leaf),
            "change_gap": (max(chg_gap, still), chg_leaf)}


def frame_numbers(prog: list, ref: list) -> dict:
    """prog / ref: lists of uint8 (H, W, 3) frames."""
    gap = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
              for a, b in zip(prog, ref))
    over = sum(int((np.abs(a.astype(np.int16) - b.astype(np.int16))
                    > 1).any(-1).sum()) for a, b in zip(prog, ref))
    px = sum(a.shape[0] * a.shape[1] for a in prog)
    return {"max_level_gap": (float(gap), None),
            "px_over_1_share": (over / px, None)}


def judge(numbers: dict, limits: dict, exact: dict | None = None) -> tuple:
    """(correct, [{"name", "value", "limit"}]): each number that has a
    limit at or under it, exact counts at 0."""
    rows = [{"name": k, "value": numbers[k][0], "limit": v}
            for k, v in limits.items()]
    rows += [{"name": k, "value": v, "limit": 0} for k, v in
             (exact or {}).items()]
    ok = all(np.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in rows)
    return ok, rows
