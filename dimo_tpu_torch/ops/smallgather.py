"""Column gather from a SMALL table: kernels K2 (forward) and K4 (backward).

Counterpart of `dimo_tpu/ops/smallgather.py::gather_small_cols` and its
custom VJP (`_gc_fwd`/`_gc_bwd`).
The LBS blend (`models/deform.py`) gathers the fused (11, M) control-point
table `[radius | c_xyz | d_xyz | d_rot]` at (K, N) neighbour indices and
reads the result component-wise as (11, K, N).

The gather is differentiable in the table: its backward adds the
(D, K, N) cotangent into the (D, M) table, dtable[d, idx[s]] += g[d, s].

On a CUDA tensor the wrappers launch the hand-written kernels in
`csrc/smallgather.cu` (K2 gather, K4 scatter-add); on a CPU tensor they
run `gather_small_cols_plain` and `gather_small_cols_bwd_plain`. There is
no other route: an unsupported input raises.

Numerics: the TPU kernels gather and scatter `hi + lo` (a bf16 split of
each value, ~2^-17 relative error); the port's are exact float32, so the
port is compared with the reference at 2e-5 of the values' scale. K4 adds
with atomics, in an order that varies from run to run.
"""
from __future__ import annotations

import ctypes

import torch

from dimo_tpu_torch import build

# launches of the CUDA kernels since the last reset, K2 and K4 (chip_smoke
# reads them)
launches = 0
bwd_launches = 0
# sites per one-hot product in the plain backward (bounds its memory)
_PLAIN_CHUNK = 1 << 16


def gather_small_cols_plain(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: table_t (D, M), idx (...) -> (D, ...) float32, with
    zeros for indices outside [0, M)."""
    d, m = table_t.shape
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < m)
    out = table_t.float()[:, flat.clamp(0, max(m - 1, 0))]
    out = torch.where(ok[None, :], out, torch.zeros((), dtype=out.dtype,
                                                    device=out.device))
    return out.reshape(d, *idx.shape)


def gather_small_cols_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                                m: int) -> torch.Tensor:
    """Plain version of kernel K4: g (D, ...) cotangent at idx (...) ->
    (D, m) float32, dtable[d, j] = sum of g[d, s] over the sites with
    idx[s] == j; indices outside [0, m) add nothing. A one-hot product in
    chunks of sites, the reference kernel's formula in float32."""
    d = g.shape[0]
    flat = idx.reshape(-1).long()
    g2 = g.reshape(d, -1).float()
    cols = torch.arange(m, device=g.device)
    out = torch.zeros((d, m), dtype=torch.float32, device=g.device)
    for i in range(0, flat.shape[0], _PLAIN_CHUNK):
        oh = (flat[i:i + _PLAIN_CHUNK, None] == cols[None, :]).float()
        out = out + g2[:, i:i + _PLAIN_CHUNK] @ oh
    return out


def _gather_cols_cuda(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global launches
    if table_t.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table_t.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != table_t.device:
        raise ValueError("table and idx must be on the same device")
    d, m = table_t.shape
    if d * m * 4 > 227 * 1024:
        raise ValueError(f"table ({d}, {m}) does not fit in shared memory")
    table_c = table_t.contiguous()
    flat = idx.reshape(-1).contiguous()
    s = flat.shape[0]
    out = torch.empty((d, s), dtype=torch.float32, device=table_t.device)
    if s > 0:
        lib = build.load("smallgather")
        fn = lib.gather_small_cols_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        props = torch.cuda.get_device_properties(table_t.device)
        stream = torch.cuda.current_stream(table_t.device).cuda_stream
        build.check(fn(table_c.data_ptr(), flat.data_ptr(), out.data_ptr(),
                       d, m, s, props.multi_processor_count, stream),
                    "gather_small_cols")
        launches += 1
    return out.reshape(d, *idx.shape)


def _scatter_cols_cuda(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    global bwd_launches
    if g.dtype != torch.float32:
        raise TypeError(f"cotangent must be float32, got {g.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if idx.device != g.device:
        raise ValueError("cotangent and idx must be on the same device")
    d = g.shape[0]
    if d * m * 4 > 227 * 1024:
        raise ValueError(f"table ({d}, {m}) does not fit in shared memory")
    flat = idx.reshape(-1).contiguous()
    s = flat.shape[0]
    g2 = g.reshape(d, s).contiguous()
    out = torch.zeros((d, m), dtype=torch.float32, device=g.device)
    if s > 0:
        lib = build.load("smallgather")
        fn = lib.gather_small_cols_bwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        props = torch.cuda.get_device_properties(g.device)
        stream = torch.cuda.current_stream(g.device).cuda_stream
        build.check(fn(g2.data_ptr(), flat.data_ptr(), out.data_ptr(), d, m,
                       s, props.multi_processor_count, stream),
                    "gather_small_cols_bwd")
        bwd_launches += 1
    return out


def gather_small_cols_bwd(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    """Transpose of `gather_small_cols`: (D, ...) cotangent -> (D, m)
    table grad. Kernel K4 on the card, the plain version on the CPU."""
    if g.device.type == "cuda":
        return _scatter_cols_cuda(g, idx, m)
    if g.device.type == "cpu":
        return gather_small_cols_bwd_plain(g, idx, m)
    raise ValueError(f"unsupported device {g.device}")


def _gather_fwd(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table_t.device.type == "cuda":
        return _gather_cols_cuda(table_t, idx)
    if table_t.device.type == "cpu":
        return gather_small_cols_plain(table_t, idx)
    raise ValueError(f"unsupported device {table_t.device}")


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_t, idx):
        ctx.save_for_backward(idx)
        ctx.m = table_t.shape[1]
        return _gather_fwd(table_t, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_small_cols_bwd(g.contiguous(), idx, ctx.m), None


def gather_small_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_t (D, M) with small M; idx (...) int -> (D, ...) float32.
    Indices outside [0, M) read zeros. Differentiable in table_t."""
    if torch.is_grad_enabled() and table_t.requires_grad:
        return _GatherCols.apply(table_t, idx)
    return _gather_fwd(table_t, idx)
