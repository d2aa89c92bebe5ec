"""Row gather of per-gaussian attribute rows, with a fixed-order backward
(the strip path's row scatter).

Counterpart of `dimo_tpu/ops/rasterizer/gather.py::gather_rows`. The
reference wraps the gather in a sort + cumsum custom VJP because a
scatter-add serialises on the TPU; its sums are the same bits on every
run. The port's backward (`gather_rows_bwd`) adds each row's slots in an
order set by the inputs alone: the slots cut by their flat index into
chunks of 1,024, each chunk's slots of the row added in slot order from 0,
then the chunks' sums in chunk order from 0. So it is the same bits on
every run, on any card and on the CPU, as the reference's, without the
reference's cumsum differences, which lose digits on rows hit by many
slots. It has no TPU kernel of its own: the reference's is plain XLA. On a
CUDA tensor it launches its kernels (`csrc/smallgather.cu`, above
`run_sums_kernel`; counted in `launches`); on a CPU tensor it runs
`gather_rows_bwd_plain`, the same sums in the same order, so the two agree
bit for bit.

Given the strips' `count`, only the live slots (c < count[t]) are read:
the compositor's backward (kernel K3) writes 0 past a count, and the
chunk cuts fall at fixed slot indices, so dropping those slots changes no
bit of the result. Without it (the tile path) every slot is read.

On the render path kernel K1 reads `coef_table` rows by list index
itself; K3 emits per-slot row grads, and `gather_rows_bwd` scatters them
into the table.
"""
from __future__ import annotations

import ctypes

import torch

from dimo_tpu_torch import build
from dimo_tpu_torch.ops import smallgather as sg

# launches of the row scatter's kernels since the last reset (chip_smoke
# reads it)
launches = 0
# g, idx, count, cap, marks, keys, start, list, part, out, m, a, s, stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6
             + [ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p])
# kLocalBits of csrc/smallgather.cu: a row index takes the other 22 bits of
# a chunk's key, less the one that marks no key
MAX_ROWS = (1 << 22) - 1
# a slot's index, and its chunk's positions, fit an int32 (the kernels' list)
MAX_SLOTS = (1 << 31) - 1 - sg.CHUNK


def _live(idx: torch.Tensor, count: torch.Tensor | None) -> torch.Tensor | None:
    """The flat mask of the slots below their strip's count (None: all)."""
    if count is None:
        return None
    if idx.dim() != 2 or count.shape != (idx.shape[0],):
        raise ValueError(f"count must be ({idx.shape[0]},) for idx "
                         f"{tuple(idx.shape)}, got {tuple(count.shape)}")
    cap = idx.shape[1]
    cols = torch.arange(cap, device=idx.device)
    return (cols[None, :] < count.to(idx.device)[:, None]).reshape(-1)


def gather_rows_bwd_plain(g: torch.Tensor, idx: torch.Tensor, m: int,
                          count: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the row scatter: g (T, C, A) at idx (T, C) -> (m,
    A) of g's dtype, summed in the kernels' order (module docstring); a
    slot at or past its strip's `count`, or with an index outside [0, m),
    adds nothing."""
    a = g.shape[-1]
    vals = g.reshape(-1, a)
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < m)
    live = _live(idx, count)
    if live is not None:
        ok &= live
    chunk = torch.arange(flat.shape[0], device=flat.device) // sg.CHUNK
    keys, pieces = sg._ordered_sums(vals[ok], chunk[ok] * m + flat[ok])
    rows, sums = sg._ordered_sums(pieces, keys % m)
    out = torch.zeros((m, a), dtype=vals.dtype, device=vals.device)
    out[rows] = sums
    return out


def gather_rows_bwd(g: torch.Tensor, idx: torch.Tensor, m: int,
                    count: torch.Tensor | None = None) -> torch.Tensor:
    """Transpose of `gather_rows`: g (T, C, A) at idx (T, C) -> (m, A),
    dattrs[k] = sum of g over the slots with idx == k, in a fixed order;
    a slot whose index lies outside [0, m), or (given the strips' int32
    `count` (T,)) at or past its strip's count, adds nothing."""
    global launches
    if g.device.type == "cpu":
        return gather_rows_bwd_plain(g, idx, m, count)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    a = g.shape[-1]
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    g2 = g.reshape(-1, a).contiguous()
    sg._rows_check("gather_rows_bwd", g2, flat, m, a)
    if a % 4 or m >= MAX_ROWS or flat.shape[0] > MAX_SLOTS:
        raise ValueError(f"gather_rows_bwd: rows of {a} floats (a multiple "
                         f"of 4), at most {MAX_ROWS - 1} rows and "
                         f"{MAX_SLOTS} slots, got {m} rows of "
                         f"{flat.shape[0]} slots")
    dev = g.device
    out = torch.empty((m, a), dtype=torch.float32, device=dev)
    if m == 0 or a == 0:
        return out
    if count is not None:
        if (idx.dim() != 2 or count.shape != (idx.shape[0],)
                or count.dtype != torch.int32 or count.device != dev):
            raise ValueError(f"count must be int32 ({idx.shape[0]},) on "
                             f"g's device for idx {tuple(idx.shape)}")
        count = count.contiguous()
    if g2.data_ptr() % 16:
        g2 = g2.clone()
    s = flat.shape[0]
    chunks = -(-s // sg.CHUNK)
    words = -(-chunks // 32)
    i32 = dict(dtype=torch.int32, device=dev)
    marks = torch.empty(m * words + -(-m // 1024), **i32)
    keys = torch.empty(chunks * sg.CHUNK, **i32)
    start = torch.empty(m + 1, **i32)
    runs = torch.empty(s, **i32)
    part = torch.empty((chunks * sg.CHUNK, a), dtype=torch.float32,
                       device=dev)
    fn = build.function("smallgather", "gather_rows_bwd_chunked", _ARGTYPES)
    build.check(fn(g2.data_ptr(), flat.data_ptr(),
                   None if count is None else count.data_ptr(),
                   idx.shape[-1], marks.data_ptr(),
                   keys.data_ptr(), start.data_ptr(), runs.data_ptr(),
                   part.data_ptr(), out.data_ptr(), m, a, s,
                   torch.cuda.current_stream(dev).cuda_stream),
                "gather_rows_bwd")
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
