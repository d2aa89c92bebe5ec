"""Column gather from a SMALL table: kernel K2 of the port.

Counterpart of `dimo_tpu/ops/smallgather.py::gather_small_cols` (forward).
The LBS blend (`models/deform.py`) gathers the fused (11, M) control-point
table `[radius | c_xyz | d_xyz | d_rot]` at (K, N) neighbour indices and
reads the result component-wise as (11, K, N).

On a CUDA tensor the wrapper launches the hand-written kernel
`csrc/smallgather.cu`; on a CPU tensor it runs `gather_small_cols_plain`.
There is no other route: an unsupported input raises.

Numerics: the TPU kernel gathers `hi + lo` (a bf16 split of each value,
~2^-17 relative error); this gather is exact, so the port is compared
with the reference at atol = 2e-5 * max|table|.

The backward (kernel K4, a scatter-add into the table) comes with the
training slice; this module is forward only.
"""
from __future__ import annotations

import ctypes

import torch

from dimo_tpu_torch import build

# launches of the CUDA kernel since the last reset (chip_smoke reads it)
launches = 0


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


def gather_small_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_t (D, M) with small M; idx (...) int -> (D, ...) float32.
    Indices outside [0, M) read zeros."""
    if table_t.device.type == "cuda":
        return _gather_cols_cuda(table_t, idx)
    if table_t.device.type == "cpu":
        return gather_small_cols_plain(table_t, idx)
    raise ValueError(f"unsupported device {table_t.device}")
