"""Row gather of per-gaussian attribute rows, with a fixed-order segment-sum
backward (the strip path's row scatter).

Counterpart of `dimo_tpu/ops/rasterizer/gather.py::gather_rows`. The
reference wraps the gather in a sort + cumsum custom VJP because a
scatter-add serialises on the TPU; its sums are the same bits on every
run. The port's backward is the sorted route of K6
(`ops/smallgather.py::scatter_sorted`, `csrc/smallgather.cu`): a stable
sort of the slots by row, then each row's slots summed in slot order, a
tile of sorted positions at a time, the pieces added in tile order. So it
is the same bits on every run, as the reference's, without the
reference's cumsum differences, which lose digits on rows hit by many
slots (the dummy row of the padded list slots among them). It has no TPU
kernel of its own: the reference's is plain XLA. On a CUDA tensor it
launches the kernel (counted in `launches`); on a CPU tensor it runs the
same sums in the same order (`smallgather.scatter_sorted_plain`), so the two
agree bit for bit.

On the render path kernel K1 reads `coef_table` rows by list index
itself; the compositor's backward (kernel K3) emits per-slot row grads,
and `gather_rows_bwd` scatters them into the table.
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.ops import smallgather as sg

# launches of the row scatter's kernels since the last reset (chip_smoke
# reads it)
launches = 0


def gather_rows_bwd(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    """Transpose of `gather_rows`: g (T, C, A) at idx (T, C) -> (m, A),
    dattrs[k] = sum of g over the slots with idx == k, in a fixed order;
    a slot whose index lies outside [0, m) adds nothing."""
    global launches
    a = g.shape[-1]
    flat = idx.reshape(-1)
    g2 = g.reshape(-1, a)
    if g.device.type == "cpu":
        return sg.scatter_sorted_plain(g2, flat.long(), m)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    flat = flat.to(torch.int32).contiguous()
    g2 = g2.contiguous()
    sg._rows_check("gather_rows_bwd", g2, flat, m, a)
    out = sg.scatter_sorted(g2, flat, m, a)
    if flat.numel() and m and a:
        launches += 1
    return out


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
