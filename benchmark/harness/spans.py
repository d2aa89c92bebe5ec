"""Readings of the program's own spans (`dimo_tpu_torch/utils/
diagnostics.py`'s recorder, on in a traced run since `drivers/
train_loop.py` marks the step) over a run's window: the last
`record["train"]["steps"]` completed `step` spans, since the program runs
no step after the window. None where the program has no recorder or kept
fewer steps."""
from __future__ import annotations


def step_mean(rec: dict, key: str) -> float | None:
    """The mean over the window's steps of one of the recorder's
    `step_totals` numbers, or None."""
    from dimo_tpu_torch.utils import diagnostics
    totals = getattr(diagnostics, "step_totals", None)
    n = (rec.get("train") or {}).get("steps")
    rows = totals(n) if totals is not None and n else None
    return sum(r[key] for r in rows) / len(rows) if rows else None
