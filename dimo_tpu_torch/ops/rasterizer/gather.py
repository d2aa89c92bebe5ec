"""Row gather of per-gaussian attribute rows, with a segment-sum backward.

Counterpart of `dimo_tpu/ops/rasterizer/gather.py::gather_rows`. The
reference wraps the gather in a sort + cumsum custom VJP because a
scatter-add serialises on the TPU. On the card a float32 `index_add_`
(atomic adds) is the natural segment sum, and it avoids the reference's
cumsum differences, which lose digits on rows hit by many slots; so the
backward here is `index_add_`, on the CPU and on the card alike.

On the render path kernel K1 reads `coef_table` rows by list index
itself; the compositor's backward (kernel K3) emits per-slot row grads,
and `gather_rows_bwd` scatters them into the table.
"""
from __future__ import annotations

import torch


def gather_rows_bwd(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    """Transpose of `gather_rows`: g (T, C, A) at idx (T, C) -> (m, A),
    dattrs[k] = sum of g over the slots with idx == k."""
    a = g.shape[-1]
    out = torch.zeros((m, a), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx.reshape(-1).long(), g.reshape(-1, a))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, idx):
        ctx.save_for_backward(idx)
        ctx.m = attrs.shape[0]
        return attrs[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_rows_bwd(g, idx, ctx.m), None


def gather_rows(attrs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """attrs (M, A) gathered at idx (T, C) -> (T, C, A)."""
    return _GatherRows.apply(attrs, idx)
