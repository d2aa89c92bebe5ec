"""Forward strip compositor: kernel K1 of the port.

Counterpart of the forward of `dimo_tpu/ops/rasterizer/composite_strips.py`:
`composite_strips(..., out_ch=7)` is the reference's `composite_strips`,
`out_ch=3` or `4` its `composite_strips_infer` with early exit. Contract,
per pixel of each 32x32 strip, front to back over the strip's
depth-ordered list:

  * the entry's power quadratic is Taylor-shifted from its home strip to
    the evaluating strip, (u, v) = 32 * (eval - home) (`_shift_coefs`,
    the reference's `_shift_slab`);
  * power = A + d * (B + d * C) at the pixel's centre-local column x and
    row d, with A, B the reference's Horner terms;
  * alpha = exp2(power), zeroed below 1/255 and capped at 0.99;
    w = alpha * T; acc += colour * w; T -= w;
  * the output holds `out_ch` channels and T_final as the last channel,
    in image layout (out_ch + 1, H_pad, W_pad).

The 7-channel variant never stops early. The 3/4-channel variant stops a
strip at a chunk boundary once every pixel of it has T < 1e-4; it never
skips the entry that crosses the threshold, so it differs from the
exhaustive result only by a T_EXIT-weighted tail.

On a CUDA tensor `composite_strips` launches `csrc/composite_strips.cu`;
on a CPU tensor it runs `composite_strips_plain`, which does the same
float32 operations in the same order (one rounding per op, as the kernel
is built with --fmad=false), exhaustively. The backward (kernel K3) comes
with the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from dimo_tpu_torch import build
from dimo_tpu_torch.ops.rasterizer.gather import gather_rows
from dimo_tpu_torch.ops.rasterizer.strips import (
    C_A, C_B, C_C, C_D, C_E, C_F, C_HSC, C_HSR, C_R, COEF_DIM, STRIP_H,
    STRIP_W, num_strips)

OUT_CH = 7            # r g b depth nx ny nz (the full path)
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EXIT = 1e-4         # early-exit threshold of the 3/4-channel variant

# launches of the CUDA kernel since the last reset, per channel variant
# ("ch7" exhaustive, "ch3"/"ch4" early exit); chip_smoke reads them
launches = {"ch3": 0, "ch4": 0, "ch7": 0}


def _shift_coefs(rows: torch.Tensor, sc: torch.Tensor, sr: torch.Tensor):
    """Home-frame table rows (..., 16) -> eval-frame (cA, cB, cC, cD, cE, cF)
    for eval strip ids sc/sr broadcastable to rows[..., 0]."""
    u = STRIP_W * (sc - rows[..., C_HSC])
    v = STRIP_H * (sr - rows[..., C_HSR])
    cA, cB, cC = rows[..., C_A], rows[..., C_B], rows[..., C_C]
    cD, cE, cF = rows[..., C_D], rows[..., C_E], rows[..., C_F]
    cD2 = cD + 2.0 * u * cA + v * cB
    cE2 = cE + 2.0 * v * cC + u * cB
    cF2 = cF + u * u * cA + u * v * cB + v * v * cC + u * cD + v * cE
    return cA, cB, cC, cD2, cE2, cF2


def composite_strips_plain(table: torch.Tensor, idx: torch.Tensor,
                           count: torch.Tensor, height: int, width: int,
                           out_ch: int = OUT_CH) -> torch.Tensor:
    """Plain version: exhaustive front-to-back composite of every strip's
    list. table (N+1, 16); idx (Ns, CS) int; count (Ns,) int.
    Returns (out_ch + 1, height, width), last channel = T_final."""
    nrows, ncols = num_strips(height, width)
    ns = nrows * ncols
    dev = table.device
    rows = gather_rows(table, idx)                            # (Ns, CS, 16)
    sid = torch.arange(ns, device=dev)
    sc = (sid % ncols).to(table.dtype)[:, None]
    sr = (sid // ncols).to(table.dtype)[:, None]
    cA, cB, cC, cD, cE, cF = _shift_coefs(rows, sc, sr)       # (Ns, CS)
    x = (torch.arange(STRIP_W, device=dev) - STRIP_W // 2).to(table.dtype)
    d = torch.arange(STRIP_H, device=dev).to(table.dtype)[:, None]  # (32, 1)
    xx = x * x
    ex = lambda c: c[..., None]                                # (Ns, CS, 1)
    x0 = ex(cA) * xx + ex(cD) * x + ex(cF)                     # (Ns, CS, 32)
    x1 = ex(cB) * x + ex(cE)
    x2 = ex(cC)
    h = STRIP_H // 2
    A = x0 - h * x1 + (h * h) * x2
    B = x1 - STRIP_H * x2
    cols = rows[..., C_R:C_R + out_ch]                        # (Ns, CS, ch)

    T = torch.ones((ns, STRIP_H, STRIP_W), dtype=table.dtype, device=dev)
    acc = torch.zeros((out_ch, ns, STRIP_H, STRIP_W), dtype=table.dtype,
                      device=dev)
    zero = torch.zeros((), dtype=table.dtype, device=dev)
    n_iter = int(count.max()) if ns else 0
    for j in range(min(n_iter, idx.shape[1])):
        # entries past a strip's count are the dummy row: alpha 0, no-op
        pj = A[:, None, j, :] + d * (B[:, None, j, :] + d * x2[:, None, j, :])
        ar = torch.exp2(pj)
        a = torch.where(ar >= ALPHA_EPS, torch.clamp_max(ar, ALPHA_MAX), zero)
        w = a * T
        for ch in range(out_ch):
            acc[ch] = acc[ch] + cols[:, j, ch, None, None] * w
        T = T - w
    planes = torch.cat([acc, T[None]], dim=0)        # (C+1, Ns, 32, 32)
    planes = planes.reshape(out_ch + 1, nrows, ncols, STRIP_H, STRIP_W)
    return planes.permute(0, 1, 3, 2, 4).reshape(out_ch + 1, height, width)


def _composite_cuda(table, idx, count, height, width, out_ch, entries_out):
    nrows, ncols = num_strips(height, width)
    ns = nrows * ncols
    if table.dtype != torch.float32 or table.dim() != 2 \
            or table.shape[1] != COEF_DIM:
        raise TypeError(f"table must be float32 (N+1, {COEF_DIM}), got "
                        f"{table.dtype} {tuple(table.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != ns:
        raise TypeError(f"idx must be int32 ({ns}, CS), got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if count.dtype != torch.int32 or count.shape != (ns,):
        raise TypeError(f"count must be int32 ({ns},), got {count.dtype} "
                        f"{tuple(count.shape)}")
    if entries_out is not None and (entries_out.dtype != torch.int32
                                    or entries_out.shape != (ns,)
                                    or not entries_out.is_contiguous()):
        raise TypeError("entries_out must be a contiguous int32 (Ns,) tensor")
    for t in (idx, count, entries_out):
        if t is not None and t.device != table.device:
            raise ValueError("all inputs must share the table's device")
    table_c, idx_c, count_c = (table.contiguous(), idx.contiguous(),
                               count.contiguous())
    out = torch.empty((out_ch + 1, height, width), dtype=torch.float32,
                      device=table.device)
    lib = build.load("composite_strips")
    fn = lib.composite_strips_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(table.device).cuda_stream
    build.check(fn(table_c.data_ptr(), idx_c.data_ptr(), count_c.data_ptr(),
                   out.data_ptr(),
                   entries_out.data_ptr() if entries_out is not None else None,
                   table.shape[0], idx.shape[1], nrows, ncols, out_ch, stream),
                "composite_strips")
    launches[f"ch{out_ch}"] += 1
    return out


def composite_strips(table: torch.Tensor, idx: torch.Tensor,
                     count: torch.Tensor, height: int, width: int,
                     out_ch: int = OUT_CH,
                     entries_out: torch.Tensor | None = None) -> torch.Tensor:
    """Composite every strip's list; returns (out_ch + 1, height, width)
    with T_final last. out_ch 7 composites every entry; out_ch 3 or 4 is
    the forward-only variant that stops a strip once all its pixels have
    T < T_EXIT (on the card; the CPU's plain version is exhaustive). On the
    card, `entries_out` (optional int32 (Ns,)) receives how many list
    entries each strip composited."""
    if out_ch not in (3, 4, OUT_CH):
        raise ValueError(f"out_ch must be 3, 4 or 7, got {out_ch}")
    if table.device.type == "cuda":
        return _composite_cuda(table, idx, count, height, width, out_ch,
                               entries_out)
    if table.device.type == "cpu":
        return composite_strips_plain(table, idx, count, height, width, out_ch)
    raise ValueError(f"unsupported device {table.device}")
