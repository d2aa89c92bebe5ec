"""Per-bin Gaussian list construction (plain tensor ops), and the tile
compositor's attribute table.

Counterpart of `dimo_tpu/ops/rasterizer/tiles.py`: `build_bin_lists` with
the reference's TIER2=5 medium tier hard-coded and both of its window
readout routes; `build_tile_lists`, the same over (TILE_H, TILE_W) =
(32, 128)-pixel tiles; and `pack_attrs`, the (N+1, 16) attribute table the
tile compositor (`composite_tiles.py`) reads. The reference's
`DIMO_TILE_H` sweep knob is not carried over: the tile height is 32, the
reference's default and the only height its kernels were tuned for. The
list formulation is the same duplicate-key sort:

  * each "small" gaussian (bbox within a KR x KC bin footprint) emits one
    (bin || quantized-depth, index) int32 key pair per overlapped bin
    (sentinel keys elsewhere); one global sort makes every bin's segment
    depth-complete;
  * "medium" gaussians (footprint <= TIER2 x TIER2 bins) are compacted to
    the TIER2_K nearest and emit duplicate keys into the same sort;
  * the rare larger ones are compacted globally and merged per bin by one
    row sort;
  * segments are located with searchsorted and read out as one window of
    `capacity` rows per bin, so truncation keeps each bin's NEAREST
    `capacity` entries, and `overflow`/`overflow_max` count what was cut.

Readout routes. By default the window is read with two clamped gathers
(keys and values at `starts[t] + j`). With `WINDMA` set (environment
`DIMO_WINDMA`, the reference's knob and default) the sorted keys and
values are stacked into (ND, 2) pairs and read by
`windowdma.gather_windows`: kernel K7 on the card, its plain version on
the CPU. The validity mask and everything after it are shared, so both
routes give identical lists.

Ties. `lax.sort` in the reference is not stable, and quantized depths can
collide; here every sort is `stable=True`, so equal keys keep the order
in which they were emitted (footprint slot, then gaussian index).
Lists therefore agree with the reference exactly in counts, overflow and
per-bin membership, and in order wherever keys are distinct. The depth
top-k of the medium and big tiers is a stable sort as well (lower index
first on ties, as `lax.top_k` picks); its ties matter only when more than
TIER2_K mediums (or k_big bigs) exist.

The reference's `lax.cond` branches (medium tier present, big tier
present) are Python `if`s on a scalar read back from the device: one
host sync per branch per render.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from dimo_tpu_torch.ops.rasterizer import windowdma

# the tile compositor's tile, in pixels
TILE_H = 32
TILE_W = 128
# packed attribute lanes of the tile compositor's table (padded to 16)
ATTR_DIM = 16
A_MX, A_MY, A_CA, A_CB, A_CC, A_OP = 0, 1, 2, 3, 4, 5
A_R, A_G, A_B, A_DEPTH = 6, 7, 8, 9
A_NX, A_NY, A_NZ = 10, 11, 12
A_RADIUS = 13
OUT_CH = 7  # composited channels: r g b depth nx ny nz

# duplication footprint of the small path (strips.py passes DUP for both)
DUP_KR = 2
DUP_KC = 2
# compacted medium tier: footprints up to TIER2 x TIER2 bins, TIER2_K slots
TIER2 = 5
TIER2_K = 2048
# window readout route: nonzero reads each bin's window through
# windowdma.gather_windows (kernel K7) instead of two clamped gathers
WINDMA = int(os.environ.get("DIMO_WINDMA", "0"))
# depth bits in the int32 sort key: (bin id << depth_bits) | quantized depth
DEPTH_BITS_MAX = 22
DEPTH_BITS_MIN = 16
# gaussian-index bits in the packed sort value word
GID_BITS = 25
_SENTINEL = torch.iinfo(torch.int32).max


class TileLists(NamedTuple):
    idx: torch.Tensor      # (T, C) int32 indices into the N+1-row table
    count: torch.Tensor    # (T,) int32 number of valid entries (<= C)
    overflow: torch.Tensor  # () int32 total entries dropped by capacity
    overflow_max: torch.Tensor  # () int32 worst single-bin drop


def _depth_bits_for(t: int) -> int:
    bits = 31 - max(1, t - 1).bit_length()
    bits = min(DEPTH_BITS_MAX, bits)
    assert bits >= DEPTH_BITS_MIN, (
        t, "bin count needs more int32 key bits than depth can spare")
    return bits


def _quantize_depth(depth, ok, depth_max: int):
    """Monotonic int depth key in [0, depth_max]."""
    d = torch.where(ok, depth, 0.0)
    lo = torch.min(d)
    hi = torch.max(torch.where(ok, depth, -torch.inf))
    hi = torch.where(torch.isfinite(hi), hi, lo + 1.0)
    # a true division (scalar / tensor in torch multiplies by a reciprocal)
    scale = torch.full_like(hi, depth_max) / torch.clamp_min(hi - lo, 1e-6)
    return torch.clamp((depth - lo) * scale, 0, depth_max).to(torch.int32)


def _nearest_k(key: torch.Tensor, k: int):
    """(keys, indices) of the k smallest keys, ascending, lower index first
    on ties (the selection `lax.top_k(-key, k)` makes)."""
    skey, sidx = torch.sort(key, stable=True)
    return skey[:k], sidx[:k].to(torch.int32)


def num_tiles(height: int, width: int) -> tuple[int, int]:
    """(rows, columns) of 32 x 128 tiles; the image must be whole tiles."""
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"image {height} x {width} is not a multiple of "
                         f"the {TILE_H} x {TILE_W} tile")
    return height // TILE_H, width // TILE_W


def build_tile_lists(mean2d, radius, depth, ok, height: int, width: int,
                     capacity: int) -> TileLists:
    """Depth-ordered fixed-capacity per-tile Gaussian lists."""
    nrows, ncols = num_tiles(height, width)
    return build_bin_lists(mean2d, radius, depth, ok, nrows, ncols,
                           TILE_H, TILE_W, capacity)


def pack_attrs(mean2d, conic, opacity, color, depth, normal,
               radius=None) -> torch.Tensor:
    """Stack per-Gaussian attributes into an (N+1, 16) table; the last row
    is the zero "dummy" that padded list slots point at (opacity 0: no
    contribution). radius None stores 1e9. Differentiable in every input."""
    n = mean2d.shape[0]
    if radius is None:
        radius = torch.full((n,), 1e9, dtype=mean2d.dtype,
                            device=mean2d.device)
    cols = [mean2d[:, 0], mean2d[:, 1],
            conic[:, 0], conic[:, 1], conic[:, 2],
            opacity[:, 0],
            color[:, 0], color[:, 1], color[:, 2],
            depth,
            normal[:, 0], normal[:, 1], normal[:, 2],
            radius]
    attrs = torch.stack(cols, dim=-1)                          # (N, 14)
    attrs = torch.cat([attrs, attrs.new_zeros((n, ATTR_DIM - len(cols)))], -1)
    return torch.cat([attrs, attrs.new_zeros((1, ATTR_DIM))], dim=0)


def build_bin_lists(mean2d, radius, depth, ok, nrows: int, ncols: int,
                    bin_h: int, bin_w: int, capacity: int,
                    kr: int = DUP_KR, kc: int = DUP_KC) -> TileLists:
    """Depth-ordered fixed-capacity per-bin Gaussian lists over an
    (nrows x ncols) grid of (bin_h x bin_w)-pixel bins.

    Args: mean2d (N,2) pixel coords, radius (N,) screen radius, depth (N,),
    ok (N,) bool, all detached. Returns indices in [0, N]; N is the
    "dummy" row.
    """
    dev = depth.device
    n = depth.shape[0]
    t = nrows * ncols
    depth_bits = _depth_bits_for(t)
    depth_max = (1 << depth_bits) - 1
    i32 = torch.int32

    cmin = torch.floor((mean2d[:, 0] - radius) / bin_w).to(i32)
    cmax = torch.floor((mean2d[:, 0] + radius) / bin_w).to(i32)
    rmin = torch.floor((mean2d[:, 1] - radius) / bin_h).to(i32)
    rmax = torch.floor((mean2d[:, 1] + radius) / bin_h).to(i32)

    on_screen = (cmax >= 0) & (cmin <= ncols - 1) & (rmax >= 0) & (rmin <= nrows - 1)
    alive = ok & (radius > 0.0) & on_screen
    cmin = cmin.clamp(0, ncols - 1)
    cmax = cmax.clamp(0, ncols - 1)
    rmin = rmin.clamp(0, nrows - 1)
    rmax = rmax.clamp(0, nrows - 1)

    dq = _quantize_depth(depth, alive, depth_max)                       # (N,)
    gid = torch.arange(n, dtype=i32, device=dev)

    small = alive & (cmax - cmin < kc) & (rmax - rmin < kr)
    big = alive & ~small

    keys, vals = [], []
    # --- small path: one (bin||depth, gid) pair per overlapped bin
    assert n < (1 << GID_BITS), (n, "gid field in the packed value word")
    for dr in range(kr):
        for dc in range(kc):
            need = small & (rmax - rmin >= dr) & (cmax - cmin >= dc)
            b = (rmin + dr) * ncols + (cmin + dc)
            keys.append(torch.where(need, (b << depth_bits) | dq, _SENTINEL))
            vals.append(gid)

    # --- medium tier: the TIER2_K nearest mediums, duplicate keys into the
    # same sort. Host read of n_med stands for the reference's lax.cond.
    med_drop = torch.zeros((), dtype=i32, device=dev)
    if TIER2 > max(kr, kc):
        med = big & (cmax - cmin < TIER2) & (rmax - rmin < TIER2)
        big = big & ~med
        n_med = torch.sum(med.to(i32))
        k_med = min(TIER2_K, n)
        if int(n_med) > 0:
            med_dq, med_i = _nearest_k(torch.where(med, dq, depth_max + 1), k_med)
            mvalid = med_dq <= depth_max
            rmin_m, rmax_m = rmin[med_i], rmax[med_i]
            cmin_m, cmax_m = cmin[med_i], cmax[med_i]
            for dr in range(TIER2):
                for dc in range(TIER2):
                    need = (mvalid & (rmax_m - rmin_m >= dr)
                            & (cmax_m - cmin_m >= dc))
                    b = (rmin_m + dr) * ncols + (cmin_m + dc)
                    keys.append(torch.where(need, (b << depth_bits) | med_dq,
                                            _SENTINEL))
                    vals.append(med_i)
        # beyond k_med the DEEPEST mediums are dropped whole (counted)
        med_drop = torch.clamp_min(n_med - k_med, 0).to(i32)

    allk = torch.cat(keys)
    skey, perm = torch.sort(allk, stable=True)
    sval = torch.cat(vals)[perm]
    nd = skey.shape[0]

    tile_base = torch.arange(t, dtype=i32, device=dev) << depth_bits
    starts = torch.searchsorted(skey, tile_base).to(i32)                 # (T,)
    ends = torch.searchsorted(skey, tile_base + (1 << depth_bits)).to(i32)
    seg_len = ends - starts
    offs = starts[:, None] + torch.arange(capacity, dtype=i32, device=dev)[None]
    inc = offs < ends[:, None]                                          # (T,C)
    if WINDMA:
        pairs = torch.stack([skey, sval], dim=1)                        # (ND,2)
        rows = windowdma.gather_windows(pairs, starts, capacity)        # (T,C,2)
        wkey, wval = rows[..., 0], rows[..., 1]
    else:
        at = offs.clamp_max(nd - 1).long()
        wkey, wval = skey[at], sval[at]
    small_dq = torch.where(inc, wkey & depth_max, depth_max + 1)
    small_idx = torch.where(inc, wval, n)

    # --- big path, only when a big gaussian exists (host read of n_big
    # stands for the reference's lax.cond)
    n_big = int(torch.sum(big.to(i32)))
    if n_big == 0:
        count = seg_len.clamp_max(capacity)
        drops = torch.clamp_min(seg_len - capacity, 0)
        return TileLists(idx=small_idx.to(i32), count=count.to(i32),
                         overflow=(drops.sum() + med_drop).to(i32),
                         overflow_max=drops.max().to(i32))

    k_big = min(1024 if min(kr, kc) <= 2 else 256, n)
    big_dq_sel, big_i = _nearest_k(torch.where(big, dq, depth_max + 1), k_big)
    bs_valid = big_dq_sel <= depth_max
    tr = (torch.arange(t, dtype=i32, device=dev) // ncols)[:, None]
    tc = (torch.arange(t, dtype=i32, device=dev) % ncols)[:, None]
    ovb = (bs_valid[None, :]
           & (tc >= cmin[big_i][None, :]) & (tc <= cmax[big_i][None, :])
           & (tr >= rmin[big_i][None, :]) & (tr <= rmax[big_i][None, :]))
    big_dq_t = torch.where(ovb, big_dq_sel[None, :], depth_max + 1)     # (T,Kb)
    big_idx = torch.where(ovb, big_i[None, :], n)

    # --- merge by depth per bin (row sort over C + Kb columns)
    mk = torch.cat([small_dq, big_dq_t], dim=1)
    mv = torch.cat([small_idx, big_idx], dim=1)
    mk, order = torch.sort(mk, dim=1, stable=True)
    mv = torch.gather(mv, 1, order)
    idx = mv[:, :capacity]
    valid_slot = mk[:, :capacity] <= depth_max
    count = torch.sum(valid_slot.to(i32), dim=1)
    per_tile_total = seg_len + torch.sum(ovb.to(i32), dim=1)
    drops = torch.clamp_min(per_tile_total - capacity, 0)
    # k_big truncation drops whole gaussians globally: counted in the total,
    # not in overflow_max (capacity escalation cannot fix it)
    overflow = drops.sum() + max(n_big - k_big, 0) + med_drop
    return TileLists(idx=idx.to(i32), count=count.to(i32),
                     overflow=overflow.to(i32),
                     overflow_max=drops.max().to(i32))
