"""Strip binning + the per-gaussian coefficient table.

Counterpart of `dimo_tpu/ops/rasterizer/strips.py`. The image is cut into
32x32-pixel STRIPS; each strip has a depth-ordered list of up to
`capacity` entries (`build_strip_lists`), and each gaussian one row of
the (N+1, 16) `coef_table`: its screen-space power quadratic in its home
strip's CENTER-local frame (log2-scaled, log2(opacity) folded into cF),
its composited channels and its home strip ids.

Layout. The reference packs four strips into one 128-lane buffer and
ships per-buffer coefficient slabs (`build_buffers`) to its kernel, then
permutes the kernel's planes back (`reassemble`). The port's compositor
(kernel K1, `composite_strips.py`) runs one CUDA block per strip, reads
the table rows by list index itself and writes the image directly, so it
needs neither. `BUF_W` stays only as the width padding, so the strip grid
(and with it the binning) is the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dimo_tpu_torch.ops.rasterizer import tiles as tiles_mod

STRIP_H = 32
STRIP_W = 32
S_PER_BUF = 4
BUF_W = S_PER_BUF * STRIP_W     # image width is padded to a multiple of this
DUP = 2                         # small-path footprint: DUP x DUP strips

INV_LN2 = 1.4426950408889634    # coefficients are log2-scaled: alpha = exp2

# coefficient-table lane layout (N+1 rows; the last row is the dummy whose
# cF = DUMMY_CF makes padded list slots contribute exactly nothing)
C_A, C_B, C_C, C_D, C_E, C_F = 0, 1, 2, 3, 4, 5
C_R, C_G, C_B2, C_DEPTH = 6, 7, 8, 9
C_NX, C_NY, C_NZ = 10, 11, 12
C_HSC, C_HSR = 13, 14
COEF_DIM = 16
DUMMY_CF = -1e4


class StripLists(NamedTuple):
    idx: torch.Tensor      # (Ns, CS) int32 indices into the N+1-row table
    count: torch.Tensor    # (Ns,) int32 live entries (<= CS)
    overflow: torch.Tensor  # () int32 exact entries beyond capacity
    overflow_max: torch.Tensor  # () int32 worst single-strip drop


def num_strips(height: int, width: int) -> tuple[int, int]:
    assert height % STRIP_H == 0 and width % BUF_W == 0, (height, width)
    return height // STRIP_H, width // STRIP_W


def build_strip_lists(mean2d, radius, depth, ok, height: int, width: int,
                      capacity: int) -> StripLists:
    """Depth-ordered fixed-capacity per-strip entry lists."""
    nrows, ncols = num_strips(height, width)
    lists = tiles_mod.build_bin_lists(mean2d, radius, depth, ok,
                                      nrows, ncols, STRIP_H, STRIP_W,
                                      capacity, kr=DUP, kc=DUP)
    return StripLists(idx=lists.idx, count=lists.count,
                      overflow=lists.overflow,
                      overflow_max=lists.overflow_max)


def strip_owners(count: torch.Tensor, capacity: int, n: int) -> torch.Tensor:
    """(Ns,) rank of each strip when one render is sharded over n ranks:
    the strips sorted by their live entries (heaviest first, ties by strip
    id) are dealt round-robin, so every rank gets an equal mix of heavy
    and light strips (the reference deals its 4-strip buffers the same
    way, `dimo_tpu/ops/rasterizer/strips.py::build_buffers`)."""
    counts = torch.clamp(count, max=capacity)
    order = torch.sort(-counts, stable=True).indices
    owner = torch.empty_like(order)
    owner[order] = torch.arange(order.shape[0], device=order.device) % n
    return owner


def coef_table(mean2d, conic, opacity, color, depth, normal,
               height: int, width: int) -> torch.Tensor:
    """(N+1, 16) per-gaussian table: home-strip-CENTER-local power-quadratic
    coefficients (log2-scaled), composited channels, and home strip ids;
    (R, N+1, 16) for inputs with a leading render axis (mean2d (R, N, 2);
    the opacity (N, 1) is shared).

    power2(x, y) = cA x^2 + cB xy + cC y^2 + cD x + cE y + cF and
    alpha = exp2(power2), with log2(opacity) folded into cF.
    """
    nrows, ncols = num_strips(height, width)
    mx, my = mean2d[..., 0], mean2d[..., 1]
    hsc = torch.clamp(torch.floor(mx.detach() / STRIP_W), 0, ncols - 1)
    hsr = torch.clamp(torch.floor(my.detach() / STRIP_H), 0, nrows - 1)
    mxl = mx - (hsc * STRIP_W + STRIP_W // 2)
    myl = my - (hsr * STRIP_H + STRIP_H // 2)
    ca, cb, cc = conic[..., 0], conic[..., 1], conic[..., 2]
    op = opacity[..., 0]
    s = INV_LN2
    cA = -0.5 * s * ca
    cB = -s * cb
    cC = -0.5 * s * cc
    cD = s * (ca * mxl + cb * myl)
    cE = s * (cc * myl + cb * mxl)
    # clamp at a NORMAL float32: 1e-30, not a denormal, so log stays finite
    # on hardware that flushes denormals
    cF = (cA * mxl * mxl + cC * myl * myl - s * cb * mxl * myl
          + s * torch.log(torch.clamp_min(op, 1e-30)))
    cols = [cA, cB, cC, cD, cE, cF,
            color[..., 0], color[..., 1], color[..., 2], depth,
            normal[..., 0], normal[..., 1], normal[..., 2],
            hsc, hsr, torch.zeros_like(mx)]
    tab = torch.stack(cols, dim=-1)                          # (..., N, 16)
    dummy = torch.zeros((*tab.shape[:-2], 1, COEF_DIM), dtype=tab.dtype,
                        device=tab.device)
    dummy[..., C_F] = DUMMY_CF    # a fill on the device: the host waits not
    return torch.cat([tab, dummy], dim=-2).contiguous()
