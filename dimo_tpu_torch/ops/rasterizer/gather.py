"""Row gather of per-gaussian attribute rows (forward).

Counterpart of `dimo_tpu/ops/rasterizer/gather.py::gather_rows`. The
reference wraps the gather in a sort-based custom VJP (scatter serialises
on the TPU); that backward comes with the training slice. On the port's
render path the compositor kernel reads `coef_table` rows by list index
itself, so this function serves the plain compositor and the tests.
"""
from __future__ import annotations

import torch


def gather_rows(attrs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """attrs (M, A) gathered at idx (T, C) -> (T, C, A)."""
    return attrs[idx.long()]
