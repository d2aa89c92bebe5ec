"""Strip compositor, forward (kernel K1) and backward (kernel K3).

Counterpart of `dimo_tpu/ops/rasterizer/composite_strips.py`:
`composite_strips(..., out_ch=7)` is the reference's differentiable
`composite_strips` (custom VJP `_cs_fwd`/`_cs_bwd`), `out_ch=3` or `4` its
forward-only `composite_strips_infer` with early exit. Contract, per pixel
of each 32x32 strip, front to back over the strip's depth-ordered list:

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
exhaustive result only by a T_EXIT-weighted tail. It has no backward, as
in the reference: asking for a gradient through it raises.

The backward (`_cs_bwd`) walks each list back to front, replays alpha
exactly as the forward computed it, rebuilds T by division from T_final
(T = T * (1 / (1 - a))), carries the suffix colour sum, and emits each
list slot's gradient on the home-frame table row: six power
coefficients (eval-frame moments chained back through the Taylor shift,
the reference's `_unshift_grad`) and seven channel values; the id lanes
get 0, and slots past a strip's count are 0. `gather_rows_bwd` adds the
slots below each strip's count into the (N+1, 16) table gradient.

On a CUDA tensor the wrappers launch `csrc/composite_strips.cu` (K1
forward, K3 backward); on a CPU tensor they run `composite_strips_plain`
and `composite_strips_bwd_plain`, which do the same float32 operations
per pixel in the same order (one rounding per op, as the kernels are
built with --fmad=false), so a kernel and its plain version differ only
in the order of K3's per-entry sums over the strip's pixels.

The kernels give each CUDA block one row group of a strip (`GROUP_ROWS`
rows, `ROWS_PER_THREAD` rows a thread, `CHUNK` list entries staged a
pass, one a thread). The early-exit variant votes per row group at chunk
boundaries (`early_exit_entries` replays where each group stops); K3
writes per-group partials into a scratch of (Ns, GROUPS, CS, 16) that a
second pass adds in group order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dimo_tpu_torch import build
from dimo_tpu_torch.ops.rasterizer.gather import gather_rows, gather_rows_bwd
from dimo_tpu_torch.ops.rasterizer.strips import (
    C_A, C_B, C_C, C_D, C_E, C_F, C_HSC, C_HSR, C_R, COEF_DIM, STRIP_H,
    STRIP_W, num_strips)
from dimo_tpu_torch.utils.general import per_render

OUT_CH = 7            # r g b depth nx ny nz (the full path)
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EXIT = 1e-4         # early-exit threshold of the 3/4-channel variant
LN2 = 0.6931471805599453

# the kernels' work layout (csrc/composite_strips.cu: kRows, kGroupRows,
# kGroups, kChunk)
ROWS_PER_THREAD = 4
GROUP_ROWS = 8
GROUPS = STRIP_H // GROUP_ROWS
CHUNK = STRIP_W * GROUP_ROWS // ROWS_PER_THREAD

# launches of the CUDA kernels since the last reset: K1 per channel variant
# ("ch7" exhaustive, "ch3"/"ch4" early exit) and K3 ("bwd", its group pass
# and the pass that adds the groups); chip_smoke reads them
launches = {"ch3": 0, "ch4": 0, "ch7": 0, "bwd": 0}
# table, idx, count, out, entries, table_rows, cs, nrows, ncols, out_ch, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# table, idx, count, tfin, gout, dpart, dslot, table_rows, cs, nrows, ncols,
# stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _shift_coefs(rows: torch.Tensor, sc: torch.Tensor, sr: torch.Tensor):
    """Home-frame table rows (..., 16) -> eval-frame (cA, cB, cC, cD, cE, cF)
    for eval strip ids sc/sr broadcastable to rows[..., 0]."""
    u, v = _shift_uv(rows, sc, sr)
    cA, cB, cC = rows[..., C_A], rows[..., C_B], rows[..., C_C]
    cD, cE, cF = rows[..., C_D], rows[..., C_E], rows[..., C_F]
    cD2 = cD + 2.0 * u * cA + v * cB
    cE2 = cE + 2.0 * v * cC + u * cB
    cF2 = cF + u * u * cA + u * v * cB + v * v * cC + u * cD + v * cE
    return cA, cB, cC, cD2, cE2, cF2


def _shift_uv(rows: torch.Tensor, sc: torch.Tensor, sr: torch.Tensor):
    """The Taylor-shift offsets (u, v) = 32 * (eval - home) of each row."""
    return STRIP_W * (sc - rows[..., C_HSC]), STRIP_H * (sr - rows[..., C_HSR])


def _unshift_grad(d6: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Transpose of the Taylor shift's Jacobian: eval-frame grads (..., 6)
    on (cA..cF) -> home-frame grads (..., 6)."""
    dA, dB, dC, dD, dE, dF = d6.unbind(-1)
    return torch.stack([dA + 2.0 * u * dD + u * u * dF,
                        dB + v * dD + u * dE + u * v * dF,
                        dC + 2.0 * v * dE + v * v * dF,
                        dD + u * dF, dE + v * dF, dF], dim=-1)


class _Planes(NamedTuple):
    """What the plain forward and backward share, per (strip, slot)."""
    A: torch.Tensor      # (Ns, CS, 32) power at d = 0, per column x
    B: torch.Tensor      # (Ns, CS, 32) d-linear term
    C: torch.Tensor      # (Ns, CS, 1) d-quadratic term (cC)
    cols: torch.Tensor   # (Ns, CS, out_ch) channel values
    rows: torch.Tensor   # (Ns, CS, 16) home-frame rows
    sc: torch.Tensor     # (Ns, 1) eval strip column
    sr: torch.Tensor     # (Ns, 1) eval strip row
    x: torch.Tensor      # (32,) centre-local column
    d: torch.Tensor      # (32, 1) row from the strip top


def _plain_planes(table, idx, height, width, out_ch) -> _Planes:
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
    return _Planes(A, B, x2, rows[..., C_R:C_R + out_ch], rows, sc, sr, x, d)


def _alpha(pl: _Planes, j: int):
    """(alpha, araw) of slot j at every pixel of every strip, (Ns, 32, 32)."""
    pj = pl.A[:, None, j, :] + pl.d * (pl.B[:, None, j, :]
                                       + pl.d * pl.C[:, None, j, :])
    ar = torch.exp2(pj)
    zero = torch.zeros((), dtype=ar.dtype, device=ar.device)
    return torch.where(ar >= ALPHA_EPS, torch.clamp_max(ar, ALPHA_MAX), zero), ar


def _to_strips(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(C, H, W) image layout -> (C, Ns, 32, 32) strip layout."""
    nrows, ncols = num_strips(height, width)
    c = img.shape[0]
    s = img.reshape(c, nrows, STRIP_H, ncols, STRIP_W).permute(0, 1, 3, 2, 4)
    return s.reshape(c, nrows * ncols, STRIP_H, STRIP_W)


def composite_strips_plain(table: torch.Tensor, idx: torch.Tensor,
                           count: torch.Tensor, height: int, width: int,
                           out_ch: int = OUT_CH) -> torch.Tensor:
    """Plain version: exhaustive front-to-back composite of every strip's
    list. table (N+1, 16); idx (Ns, CS) int; count (Ns,) int.
    Returns (out_ch + 1, height, width), last channel = T_final."""
    nrows, ncols = num_strips(height, width)
    ns = nrows * ncols
    pl = _plain_planes(table, idx, height, width, out_ch)
    T = torch.ones((ns, STRIP_H, STRIP_W), dtype=table.dtype,
                   device=table.device)
    acc = torch.zeros((out_ch, ns, STRIP_H, STRIP_W), dtype=table.dtype,
                      device=table.device)
    n_iter = int(count.max()) if ns else 0
    for j in range(min(n_iter, idx.shape[1])):
        # entries past a strip's count are the dummy row: alpha 0, no-op
        a, _ = _alpha(pl, j)
        w = a * T
        for ch in range(out_ch):
            acc[ch] = acc[ch] + pl.cols[:, j, ch, None, None] * w
        T = T - w
    planes = torch.cat([acc, T[None]], dim=0)        # (C+1, Ns, 32, 32)
    planes = planes.reshape(out_ch + 1, nrows, ncols, STRIP_H, STRIP_W)
    return planes.permute(0, 1, 3, 2, 4).reshape(out_ch + 1, height, width)


def composite_strips_bwd_plain(table: torch.Tensor, idx: torch.Tensor,
                               count: torch.Tensor, tfin: torch.Tensor,
                               gout: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K3: the 7-channel composite's VJP per list
    slot. tfin (H, W) is the forward's T_final, gout (8, H, W) the
    cotangent of its 7 channels and T_final. Returns (Ns, CS, 16) home-frame
    row grads, zero past each strip's count and on the id lanes."""
    height, width = tfin.shape
    ns, cs = idx.shape
    pl = _plain_planes(table, idx, height, width, OUT_CH)
    g = _to_strips(gout, height, width)                       # (8, Ns, 32, 32)
    T = _to_strips(tfin[None], height, width)[0]
    gs = g[OUT_CH] * T             # suffix: what lies behind the entry
    y = pl.d - STRIP_H // 2        # centre-local row
    x = pl.x
    one = torch.ones_like(x * y)
    feats = torch.stack([x * x * one, x * y, y * y * one, x * one,
                         y * one, one])                       # (6, 32, 32)
    dcoef = torch.zeros((ns, cs, 6), dtype=table.dtype, device=table.device)
    dcol = torch.zeros((ns, cs, OUT_CH), dtype=table.dtype,
                       device=table.device)
    zero = torch.zeros((), dtype=table.dtype, device=table.device)
    n_iter = min(int(count.max()) if ns else 0, cs)
    for j in reversed(range(n_iter)):
        a, ar = _alpha(pl, j)
        inv = 1.0 / (1.0 - a)
        T = T * inv                # T in front of entry j
        w = a * T
        cg = g[0] * pl.cols[:, j, 0, None, None]
        for ch in range(1, OUT_CH):
            cg = cg + g[ch] * pl.cols[:, j, ch, None, None]
        dalpha = cg * T - gs * inv
        gs = gs + cg * w
        gate = (ar >= ALPHA_EPS) & (ar < ALPHA_MAX)
        dpow = torch.where(gate, dalpha, zero) * ar * LN2
        dcoef[:, j] = torch.einsum("spq,kpq->sk", dpow, feats)
        dcol[:, j] = torch.einsum("cspq,spq->sc", g[:OUT_CH], w)
    u, v = _shift_uv(pl.rows, pl.sc, pl.sr)
    out = torch.cat([_unshift_grad(dcoef, u, v), dcol,
                     torch.zeros((ns, cs, COEF_DIM - 6 - OUT_CH),
                                 dtype=table.dtype, device=table.device)], -1)
    live = torch.arange(cs, device=table.device)[None, :] < count[:, None]
    return torch.where(live[..., None], out, zero)


def early_exit_entries(table: torch.Tensor, idx: torch.Tensor,
                       count: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """List entries the early-exit kernel walks per (strip, row group),
    replayed with the plain version's T: a group stops at the first chunk
    boundary (a multiple of CHUNK, inside its list) at which every one of
    its pixels has T < T_EXIT, else it walks the whole list. Returns
    int64 (Ns, GROUPS)."""
    ns, cs = idx.shape
    groups = GROUPS
    pl = _plain_planes(table, idx, height, width, 1)
    n = torch.clamp(count.long(), 0, cs)
    walked = n[:, None].repeat(1, groups)
    open_ = torch.ones((ns, groups), dtype=torch.bool, device=table.device)
    T = torch.ones((ns, STRIP_H, STRIP_W), dtype=table.dtype,
                   device=table.device)
    for j in range(int(n.max()) if ns else 0):
        if j and j % CHUNK == 0:
            below = (T < T_EXIT).reshape(ns, groups, -1).all(-1)
            stop = open_ & below & (j < n)[:, None]
            walked = torch.where(stop, j, walked)
            open_ = open_ & ~stop
        a, _ = _alpha(pl, j)
        T = T - a * T
    return walked


def _check_lists(table, idx, count, ns):
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


def _composite_cuda(table, idx, count, height, width, out_ch, entries_out):
    nrows, ncols = num_strips(height, width)
    ns = nrows * ncols
    _check_lists(table, idx, count, ns)
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
    fn = build.function("composite_strips", "composite_strips_fwd",
                        _FWD_ARGTYPES)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    if entries_out is not None:
        entries_out.zero_()      # the row groups of a strip atomicMax into it
    build.check(fn(table_c.data_ptr(), idx_c.data_ptr(), count_c.data_ptr(),
                   out.data_ptr(),
                   entries_out.data_ptr() if entries_out is not None else None,
                   table.shape[0], idx.shape[1], nrows, ncols, out_ch, stream),
                "composite_strips")
    launches[f"ch{out_ch}"] += 1
    return out


def _composite_bwd_cuda(table, idx, count, tfin, gout):
    height, width = tfin.shape
    nrows, ncols = num_strips(height, width)
    ns, cs = idx.shape
    _check_lists(table, idx, count, nrows * ncols)
    if tfin.dtype != torch.float32 or gout.dtype != torch.float32 \
            or gout.shape != (OUT_CH + 1, height, width):
        raise TypeError(f"tfin must be float32 (H, W) and gout float32 "
                        f"({OUT_CH + 1}, H, W), got {tfin.dtype} "
                        f"{tuple(tfin.shape)} / {gout.dtype} "
                        f"{tuple(gout.shape)}")
    for t in (idx, count, tfin, gout):
        if t.device != table.device:
            raise ValueError("all inputs must share the table's device")
    ins = [t.contiguous() for t in (table, idx, count, tfin, gout)]
    dpart = torch.empty((ns, GROUPS, cs, COEF_DIM),
                        dtype=torch.float32, device=table.device)
    out = torch.empty((ns, cs, COEF_DIM), dtype=torch.float32,
                      device=table.device)
    fn = build.function("composite_strips", "composite_strips_bwd",
                        _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    build.check(fn(*(t.data_ptr() for t in ins), dpart.data_ptr(),
                   out.data_ptr(),
                   table.shape[0], cs, nrows, ncols, stream),
                "composite_strips_bwd")
    launches["bwd"] += 1
    return out


def _forward(table, idx, count, height, width, out_ch, entries_out=None):
    """Each render's composite, (R, out_ch + 1, H, W): one launch a render
    on the card."""
    def one(i):
        e = entries_out[i] if entries_out is not None else None
        if table.device.type == "cuda":
            return _composite_cuda(table[i], idx[i], count[i], height, width,
                                   out_ch, e)
        if table.device.type == "cpu":
            return composite_strips_plain(table[i], idx[i], count[i], height,
                                          width, out_ch)
        raise ValueError(f"unsupported device {table.device}")
    return per_render(one, table.shape[0])


def composite_strips_bwd(table: torch.Tensor, idx: torch.Tensor,
                         count: torch.Tensor, tfin: torch.Tensor,
                         gout: torch.Tensor) -> torch.Tensor:
    """Per-slot VJP of the 7-channel composite (see
    `composite_strips_bwd_plain`): kernel K3 on the card, the plain
    version on the CPU."""
    if table.device.type == "cuda":
        return _composite_bwd_cuda(table, idx, count, tfin, gout)
    if table.device.type == "cpu":
        return composite_strips_bwd_plain(table, idx, count, tfin, gout)
    raise ValueError(f"unsupported device {table.device}")


class _Composite(torch.autograd.Function):
    """The 7-channel composite of R renders with its VJP, differentiable
    in the (R, N+1, 16) table (the reference's `composite_strips` custom
    VJP): K3 and the row scatter once a render."""

    @staticmethod
    def forward(ctx, table, idx, count, height, width):
        out = _forward(table, idx, count, height, width, OUT_CH)
        ctx.save_for_backward(table, idx, count, out)
        return out

    @staticmethod
    def backward(ctx, gout):
        table, idx, count, out = ctx.saved_tensors
        gout = gout.contiguous()

        def one(i):
            dslot = composite_strips_bwd(table[i], idx[i], count[i],
                                         out[i, OUT_CH], gout[i])
            # K3 writes 0 past a strip's count: only the live slots are read
            return gather_rows_bwd(dslot, idx[i], table.shape[1], count[i])
        return per_render(one, table.shape[0]), None, None, None, None


def composite_strips(table: torch.Tensor, idx: torch.Tensor,
                     count: torch.Tensor, height: int, width: int,
                     out_ch: int = OUT_CH,
                     entries_out: torch.Tensor | None = None) -> torch.Tensor:
    """Composite every strip's list; returns (out_ch + 1, height, width)
    with T_final last. out_ch 7 composites every entry and is
    differentiable in `table`; out_ch 3 or 4 is the forward-only variant
    that stops a strip once all its pixels have T < T_EXIT (on the card;
    the CPU's plain version is exhaustive). On the card, `entries_out`
    (optional int32 (Ns,), outside autograd only) receives how many list
    entries each strip composited. With a leading render axis on every
    input (table (R, N+1, 16), idx (R, Ns, CS), count (R, Ns)) the result
    is (R, out_ch + 1, height, width), one launch a render."""
    if out_ch not in (3, 4, OUT_CH):
        raise ValueError(f"out_ch must be 3, 4 or 7, got {out_ch}")
    if table.dim() == 2:
        return composite_strips(
            table[None], idx[None], count[None], height, width, out_ch,
            None if entries_out is None else entries_out[None])[0]
    if not (torch.is_grad_enabled() and table.requires_grad):
        return _forward(table, idx, count, height, width, out_ch, entries_out)
    if out_ch != OUT_CH:
        raise ValueError(f"the {out_ch}-channel early-exit composite is "
                         "forward only; run it under torch.no_grad() or "
                         "use out_ch=7")
    if entries_out is not None:
        raise ValueError("entries_out is not filled on the autograd path")
    return _Composite.apply(table, idx, count, height, width)
