"""Tile compositor, forward (kernel K8) and backward (kernel K9).

Counterpart of `dimo_tpu/ops/rasterizer/composite_pallas.py`: `composite`
is the reference's differentiable `composite` (custom VJP
`_composite_fwd`/`_composite_bwd`), `composite_infer` its forward-only
`composite_infer`. The renders go through the strip compositor
(`composite_strips.py`); this one is kept, as in the reference, as a second
independent implementation that checks the first: it shares no formula
with it beyond the blend itself. Contract, per pixel of each 32x128 tile,
front to back over the tile's depth-ordered slab of packed attribute rows
(`tiles.pack_attrs` rows gathered by `tiles.build_tile_lists` indices):

  * tile-local centre mx = row.mx - x_off, my = row.my - y_off;
  * power = cA x^2 + cB x y + cC y^2 + cD x + cE y + cF at the tile-local
    pixel (x, y), with cA = -ca/2, cB = -cb, cC = -cc/2,
    cD = ca mx + cb my, cE = cc my + cb mx and
    cF = cA mx^2 + cC my^2 - cb mx my + log(max(op, 1e-30)): the opacity
    rides in the exponent, and the zero dummy row gives alpha 0;
  * alpha = exp(power), zeroed below 1/255 and capped at 0.99;
    w = alpha * T; acc += channel * w; T -= w;
  * bounded by `counts` alone: no transmittance early exit in any variant
    (`composite_infer` only skips channels).

The backward walks each slab back to front from T_final, replays alpha
exactly as the forward computed it, rebuilds T by T = T * (1 / (1 - a)),
carries one running plane GS = g_T * T_final + sum of CG * w behind the
entry, gates on the raw exponential (1/255 <= araw < 0.99), and reduces
dpower = dalpha * araw over the tile's pixels to the grads of (mx, my, ca,
cb, cc, op) plus the seven channel grads; lanes 13 to 15 get 0, and rows
past a tile's count get 0. The geometry grads are moments of dpower about
the entry's own centre (d power / d ca = -(x - mx)^2 / 2 and so on). The
reference sums moments of the tile-local x, y and chains them through the
expanded coefficients, where terms of the order of mx^2 * sum(dpower)
cancel down to sigma^2 * sum(dpower); in float32 that leaves the result
dependent on the order of the sums at 1e-4 of a column's largest grad. The
centred moments are the same derivative without that cancellation, so the
port sits nearer float64 autograd than the reference does
(`tests/test_torch_composite_tiles.py`).

On a CUDA tensor the wrappers launch `csrc/composite_tiles.cu` (K8 forward,
K9 backward); on a CPU tensor they run `composite_tiles_plain` and
`composite_tiles_bwd_plain`, which do the same float32 operations per pixel
in the same order (one rounding per op, as the kernels are built with
--fmad=false), so a kernel and its plain version differ only in the order
of K9's per-entry sums over the tile's pixels. K9 skips a pair for a warp
whose pixels all have a power below POWER_CUT: float32 exp there is below
1/255, so alpha is exactly 0 in both versions and the pair changes
nothing. The reference's `G_FWD` / `G_BWD` block sizes and
`DIMO_FORCE_INTERPRET` are TPU tuning and debugging knobs and have no
counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from dimo_tpu_torch import build
from dimo_tpu_torch.ops.rasterizer.tiles import (
    A_CA, A_CB, A_CC, A_MX, A_MY, A_OP, A_R, ATTR_DIM, OUT_CH, TILE_H, TILE_W,
    num_tiles)

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
OP_FLOOR = 1e-30      # a normal float32: 1e-38 would be flushed or denormal
GROUPS = 4            # K9's row groups: blocks, and partials, a tile
# below this power float32 exp is < 1/255, so alpha is exactly 0 (K9's
# kPowerCut; ln(1/255) = -5.541)
POWER_CUT = -5.6

# launches of the CUDA kernels since the last reset: K8 per channel variant
# and K9 ("bwd"); chip_smoke reads them
launches = {"ch3": 0, "ch4": 0, "ch7": 0, "bwd": 0}
# packed, counts, out, tfin, cap, nrows, ncols, out_ch, stream
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# packed, counts, tfin, gout, dpart, dpacked, cap, nrows, ncols, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _to_tiles(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(C, H, W) image layout -> (C, T, 32, 128) tile layout."""
    nrows, ncols = num_tiles(height, width)
    c = img.shape[0]
    s = img.reshape(c, nrows, TILE_H, ncols, TILE_W).permute(0, 1, 3, 2, 4)
    return s.reshape(c, nrows * ncols, TILE_H, TILE_W)


def _from_tiles(planes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(C, T, 32, 128) tile layout -> (C, H, W) image layout."""
    nrows, ncols = num_tiles(height, width)
    c = planes.shape[0]
    s = planes.reshape(c, nrows, ncols, TILE_H, TILE_W).permute(0, 1, 3, 2, 4)
    return s.reshape(c, height, width)


def _coeffs(packed: torch.Tensor, ncols: int) -> dict:
    """Tile-local coefficients of every slab row, (T, C) each (the
    reference's `_chunk_coeffs`)."""
    t = torch.arange(packed.shape[0], device=packed.device)
    x_off = ((t % ncols) * TILE_W).to(packed.dtype)[:, None]
    y_off = (torch.div(t, ncols, rounding_mode="floor") * TILE_H
             ).to(packed.dtype)[:, None]
    mx = packed[..., A_MX] - x_off
    my = packed[..., A_MY] - y_off
    ca, cb, cc = packed[..., A_CA], packed[..., A_CB], packed[..., A_CC]
    op = packed[..., A_OP]
    cA = -0.5 * ca
    cC = -0.5 * cc
    cD = ca * mx + cb * my
    cE = cc * my + cb * mx
    cF = (cA * mx * mx + cC * my * my - cb * mx * my
          + torch.log(torch.clamp_min(op, OP_FLOOR)))
    return dict(mx=mx, my=my, ca=ca, cb=cb, cc=cc, op=op, cA=cA, cB=-cb,
                cC=cC, cD=cD, cE=cE, cF=cF)


def _pixel_axes(ref: torch.Tensor):
    """Tile-local (x (128,), y (32, 1)) pixel coordinates as floats."""
    x = torch.arange(TILE_W, device=ref.device).to(ref.dtype)
    y = torch.arange(TILE_H, device=ref.device).to(ref.dtype)[:, None]
    return x, y


def _alpha(k: dict, j: int, x, y, live):
    """(alpha, araw) of slot j at every pixel of every tile, (T, 32, 128);
    alpha is 0 on the tiles whose count is <= j (`live` (T, 1, 1))."""
    e = lambda c: c[:, j, None, None]                          # noqa: E731
    q1 = e(k["cB"]) * y + e(k["cD"])                           # (T, 32, 1)
    q0 = (e(k["cC"]) * y + e(k["cE"])) * y + e(k["cF"])
    power = (e(k["cA"]) * x + q1) * x + q0                     # (T, 32, 128)
    ar = torch.exp(power)
    zero = torch.zeros((), dtype=ar.dtype, device=ar.device)
    cut = torch.where(ar >= ALPHA_EPS, torch.clamp_max(ar, ALPHA_MAX), zero)
    return torch.where(live, cut, zero), ar


def _check(packed, counts, height, width):
    nrows, ncols = num_tiles(height, width)
    if packed.dtype != torch.float32 or packed.dim() != 3 \
            or packed.shape[0] != nrows * ncols or packed.shape[2] != ATTR_DIM:
        raise TypeError(f"packed must be float32 ({nrows * ncols}, C, "
                        f"{ATTR_DIM}), got {packed.dtype} "
                        f"{tuple(packed.shape)}")
    if counts.dtype != torch.int32 or counts.shape != (nrows, ncols):
        raise TypeError(f"counts must be int32 ({nrows}, {ncols}), got "
                        f"{counts.dtype} {tuple(counts.shape)}")
    if counts.device != packed.device:
        raise ValueError("packed and counts must be on the same device")
    return nrows, ncols


def composite_tiles_plain(packed: torch.Tensor, counts: torch.Tensor,
                          height: int, width: int, out_ch: int = OUT_CH):
    """Plain version of kernel K8: packed (T, C, 16) slabs, counts (nrows,
    ncols) int -> (out (out_ch, height, width), tfin (height, width))."""
    nrows, ncols = _check(packed, counts, height, width)
    nt, cap = packed.shape[:2]
    k = _coeffs(packed, ncols)
    x, y = _pixel_axes(packed)
    cnt = counts.reshape(-1).clamp(0, cap)
    T = packed.new_ones((nt, TILE_H, TILE_W))
    acc = packed.new_zeros((out_ch, nt, TILE_H, TILE_W))
    for j in range(int(cnt.max()) if nt else 0):
        a, _ = _alpha(k, j, x, y, (cnt > j)[:, None, None])
        w = a * T
        for ch in range(out_ch):
            acc[ch] = acc[ch] + packed[:, j, A_R + ch, None, None] * w
        T = T - w
    return (_from_tiles(acc, height, width),
            _from_tiles(T[None], height, width)[0])


def composite_tiles_bwd_plain(packed: torch.Tensor, counts: torch.Tensor,
                              tfin: torch.Tensor, gout: torch.Tensor
                              ) -> torch.Tensor:
    """Plain version of kernel K9: the 7-channel composite's VJP. tfin
    (H, W) is the forward's T_final, gout (8, H, W) the cotangent of its 7
    channels and of T_final. Returns dpacked (T, C, 16), zero past each
    tile's count and on lanes 13 to 15."""
    height, width = tfin.shape
    nrows, ncols = _check(packed, counts, height, width)
    nt, cap = packed.shape[:2]
    k = _coeffs(packed, ncols)
    x, y = _pixel_axes(packed)
    cnt = counts.reshape(-1).clamp(0, cap)
    g = _to_tiles(gout, height, width)                        # (8, T, 32, 128)
    T = _to_tiles(tfin[None], height, width)[0]
    gs = g[OUT_CH] * T             # what lies behind the entry
    mom = packed.new_zeros((nt, cap, 6))    # Mxx, Mxy, Myy, Mx, My, M0
    dcol = packed.new_zeros((nt, cap, OUT_CH))
    zero = packed.new_zeros(())
    for j in reversed(range(int(cnt.max()) if nt else 0)):
        live = (cnt > j)[:, None, None]
        a, ar = _alpha(k, j, x, y, live)
        inv = 1.0 / (1.0 - a)
        T = T * inv                # T in front of entry j
        w = a * T
        cg = g[0] * packed[:, j, A_R, None, None]
        for ch in range(1, OUT_CH):
            cg = cg + g[ch] * packed[:, j, A_R + ch, None, None]
        dalpha = cg * T - gs * inv
        gs = gs + cg * w
        gate = (ar >= ALPHA_EPS) & (ar < ALPHA_MAX) & live
        dpow = torch.where(gate, dalpha, zero) * ar
        dx = x - k["mx"][:, j, None, None]                     # (T, 1, 128)
        dy = (y - k["my"][:, j, None, None])[..., 0]           # (T, 32)
        s1 = dpow * dx
        s2 = (s1 * dx).sum(2)                                  # per-row sums
        s1 = s1.sum(2)
        s0 = dpow.sum(2)
        mom[:, j] = torch.stack([s2.sum(1), (dy * s1).sum(1),
                                 (dy * dy * s0).sum(1), s1.sum(1),
                                 (dy * s0).sum(1), s0.sum(1)], dim=-1)
        dcol[:, j] = torch.einsum("ctpq,tpq->tc", g[:OUT_CH], w)
    mxx, mxy, myy, m_x, m_y, m_0 = mom.unbind(-1)
    ca, cb, cc, op = (k[n] for n in ("ca", "cb", "cc", "op"))
    dgeo = torch.stack([
        ca * m_x + cb * m_y,                                           # mx
        cb * m_x + cc * m_y,                                           # my
        -0.5 * mxx,                                                    # ca
        -mxy,                                                          # cb
        -0.5 * myy,                                                    # cc
        torch.where(op > OP_FLOOR, m_0 / torch.clamp_min(op, OP_FLOOR),
                    zero),                                             # op
    ], dim=-1)
    out = torch.cat([dgeo, dcol,
                     packed.new_zeros((nt, cap, ATTR_DIM - 6 - OUT_CH))], -1)
    live = torch.arange(cap, device=packed.device)[None, :] < cnt[:, None]
    return torch.where(live[..., None], out, zero)


def _composite_cuda(packed, counts, height, width, out_ch):
    nrows, ncols = _check(packed, counts, height, width)
    packed_c, counts_c = packed.contiguous(), counts.contiguous()
    out = torch.empty((out_ch, height, width), dtype=torch.float32,
                      device=packed.device)
    tfin = torch.empty((height, width), dtype=torch.float32,
                       device=packed.device)
    fn = build.function("composite_tiles", "composite_tiles_fwd",
                        _FWD_ARGTYPES)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    build.check(fn(packed_c.data_ptr(), counts_c.data_ptr(), out.data_ptr(),
                   tfin.data_ptr(), packed.shape[1], nrows, ncols, out_ch,
                   stream), "composite_tiles")
    launches[f"ch{out_ch}"] += 1
    return out, tfin


def _composite_bwd_cuda(packed, counts, tfin, gout):
    height, width = tfin.shape
    nrows, ncols = _check(packed, counts, height, width)
    if tfin.dtype != torch.float32 or gout.dtype != torch.float32 \
            or gout.shape != (OUT_CH + 1, height, width):
        raise TypeError(f"tfin must be float32 (H, W) and gout float32 "
                        f"({OUT_CH + 1}, H, W), got {tfin.dtype} "
                        f"{tuple(tfin.shape)} / {gout.dtype} "
                        f"{tuple(gout.shape)}")
    if tfin.device != packed.device or gout.device != packed.device:
        raise ValueError("all inputs must share packed's device")
    nt, cap = packed.shape[:2]
    ins = [t.contiguous() for t in (packed, counts, tfin, gout)]
    dpart = torch.empty((nt, GROUPS, cap, ATTR_DIM), dtype=torch.float32,
                        device=packed.device)
    out = torch.empty((nt, cap, ATTR_DIM), dtype=torch.float32,
                      device=packed.device)
    fn = build.function("composite_tiles", "composite_tiles_bwd",
                        _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    build.check(fn(*(t.data_ptr() for t in ins), dpart.data_ptr(),
                   out.data_ptr(), cap, nrows, ncols, stream),
                "composite_tiles_bwd")
    launches["bwd"] += 1
    return out


def _forward(packed, counts, height, width, out_ch):
    if packed.device.type == "cuda":
        return _composite_cuda(packed, counts, height, width, out_ch)
    if packed.device.type == "cpu":
        return composite_tiles_plain(packed, counts, height, width, out_ch)
    raise ValueError(f"unsupported device {packed.device}")


def composite_tiles_bwd(packed: torch.Tensor, counts: torch.Tensor,
                        tfin: torch.Tensor, gout: torch.Tensor) -> torch.Tensor:
    """VJP of the 7-channel tile composite on the slab rows (see
    `composite_tiles_bwd_plain`): kernel K9 on the card, the plain version
    on the CPU."""
    if packed.device.type == "cuda":
        return _composite_bwd_cuda(packed, counts, tfin, gout)
    if packed.device.type == "cpu":
        return composite_tiles_bwd_plain(packed, counts, tfin, gout)
    raise ValueError(f"unsupported device {packed.device}")


class _Composite(torch.autograd.Function):
    """The 7-channel tile composite with its VJP, differentiable in the
    slabs (the reference's `composite` custom VJP)."""

    @staticmethod
    def forward(ctx, packed, counts, height, width):
        out, tfin = _forward(packed, counts, height, width, OUT_CH)
        ctx.save_for_backward(packed, counts, tfin)
        return out, tfin

    @staticmethod
    def backward(ctx, gout7, gtfin):
        packed, counts, tfin = ctx.saved_tensors
        gout = torch.cat([gout7, gtfin[None]], dim=0)
        return composite_tiles_bwd(packed, counts, tfin, gout), None, None, None


def composite(packed: torch.Tensor, counts: torch.Tensor, height: int,
              width: int):
    """Composite per-tile slabs -> ((7, H, W) channels, (H, W) T_final),
    differentiable in `packed`.

    packed: (T, C, 16) depth-ordered per-tile attribute slabs.
    counts: (nrows, ncols) int32 live entries per tile (the loop bound).
    height / width: multiples of the (32, 128) tile."""
    if torch.is_grad_enabled() and packed.requires_grad:
        return _Composite.apply(packed, counts, height, width)
    return _forward(packed, counts, height, width, OUT_CH)


def composite_infer(packed: torch.Tensor, counts: torch.Tensor, height: int,
                    width: int, out_ch: int = 3):
    """Forward-only composite of the first `out_ch` channels (rgb = 3,
    + depth = 4, + normal = 7): the channels it skips cost nothing, every
    live entry is still composited. Not differentiable."""
    if out_ch not in (3, 4, OUT_CH):
        raise ValueError(f"out_ch must be 3, 4 or 7, got {out_ch}")
    with torch.no_grad():
        return _forward(packed, counts, height, width, out_ch)
