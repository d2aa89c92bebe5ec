"""Contiguous-window readout of per-bin segments: kernel K7.

Counterpart of `dimo_tpu/ops/rasterizer/windowdma.py::gather_windows`.
The binning (`tiles.py`) locates each bin's depth-complete segment inside
ONE globally sorted (key, val) pair array; every bin's rows are
contiguous, so its readout is a copy of `capacity` rows from `starts[t]`:

    out[t, j] = pairs[starts[t] + j]   where starts[t] + j < ND,
                (0, 0)                 past the end of the array.

The reference pads the array with `2 * capacity` zeros so that a window
may run past the end (`starts[t] == ND` is legal: `searchsorted` of a
bin beyond every key); here the bound check gives the same zeros.
Callers mask rows with their own validity window.

On a CUDA tensor `gather_windows` launches the hand-written kernel in
`csrc/windowdma.cu`; on a CPU tensor it runs `gather_windows_plain`.
There is no other route: an unsupported input raises. The reference's
`nburst` (DMAs kept in flight per TPU grid step) has no meaning on a
GPU, where every block is in flight at once, and is not a parameter.
"""
from __future__ import annotations

import ctypes

import torch

from dimo_tpu_torch import build

# launches of the CUDA kernel since the last reset (chip_smoke reads it)
launches = 0
# pairs, starts, out, nd, t, capacity, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def gather_windows_plain(pairs: torch.Tensor, starts: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    """Plain version: pad with `capacity` zero rows, then index with
    starts[:, None] + arange(capacity)."""
    nd = pairs.shape[0]
    pad = torch.zeros((capacity, 2), dtype=pairs.dtype, device=pairs.device)
    offs = starts.long()[:, None] + torch.arange(capacity,
                                                 device=pairs.device)[None]
    return torch.cat([pairs, pad])[offs.clamp_max(nd + capacity - 1)]


def _gather_windows_cuda(pairs: torch.Tensor, starts: torch.Tensor,
                         capacity: int) -> torch.Tensor:
    global launches
    nd, t = pairs.shape[0], starts.shape[0]
    if t > 65535:
        raise ValueError(f"{t} bins exceed the kernel's grid limit of 65535")
    if nd + capacity >= 1 << 31:
        raise ValueError(f"pair array of {nd} rows is too long for int32 "
                         "offsets")
    pairs_c = pairs.contiguous()
    starts_c = starts.contiguous()
    out = torch.empty((t, capacity, 2), dtype=torch.int32,
                      device=pairs.device)
    if t > 0 and capacity > 0:
        fn = build.function("windowdma", "gather_windows", _ARGTYPES)
        stream = torch.cuda.current_stream(pairs.device).cuda_stream
        build.check(fn(pairs_c.data_ptr(), starts_c.data_ptr(),
                       out.data_ptr(), nd, t, capacity, stream),
                    "gather_windows")
        launches += 1
    return out


def gather_windows(pairs: torch.Tensor, starts: torch.Tensor,
                   capacity: int) -> torch.Tensor:
    """(ND, 2) int32 sorted pairs + (T,) int32 window starts in [0, ND] ->
    (T, capacity, 2) int32 window rows, zeros past the end of the array.
    Kernel K7 on the card, the plain version on the CPU."""
    if pairs.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError(f"pairs and starts must be int32, got {pairs.dtype} "
                        f"and {starts.dtype}")
    if pairs.ndim != 2 or pairs.shape[1] != 2 or starts.ndim != 1:
        raise ValueError(f"pairs must be (ND, 2) and starts (T,), got "
                         f"{tuple(pairs.shape)} and {tuple(starts.shape)}")
    if starts.device != pairs.device:
        raise ValueError("pairs and starts must be on the same device")
    if pairs.device.type == "cuda":
        return _gather_windows_cuda(pairs, starts, capacity)
    if pairs.device.type == "cpu":
        return gather_windows_plain(pairs, starts, capacity)
    raise ValueError(f"unsupported device {pairs.device}")
