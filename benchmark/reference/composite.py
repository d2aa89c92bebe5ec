"""The strip compositor, written as plain tensor algebra under autograd.

Per pixel of each 32x32 strip, front to back over the strip's
depth-ordered list (the lists and the coefficient table are the copied
`strips.py`'s): the entry's power quadratic is Taylor-shifted from its
home strip to the evaluating strip, alpha = exp2(power), zeroed below
1/255 and capped at 0.99, the entry's weight is alpha times the
transmittance left in front of it, and the channels add up under those
weights. Here the transmittance is an exclusive cumulative product over
the list, formed for a block of strips at a time, and the gradient is
autograd's: no hand-written backward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .strips import C_A, C_B, C_C, C_D, C_E, C_F, C_HSC, C_HSR, C_R, \
    STRIP_H, STRIP_W, num_strips

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99


def _alpha(rows, sc, sr):
    """(S, E, 32, 32) alpha of each list entry at each pixel of its strip,
    and the raw exp2(power) before the cut and the cap."""
    u = STRIP_W * (sc - rows[..., C_HSC])
    v = STRIP_H * (sr - rows[..., C_HSR])
    cA, cB, cC = rows[..., C_A], rows[..., C_B], rows[..., C_C]
    cD = rows[..., C_D] + 2.0 * u * cA + v * cB
    cE = rows[..., C_E] + 2.0 * v * cC + u * cB
    cF = (rows[..., C_F] + u * u * cA + u * v * cB + v * v * cC + u * rows[..., C_D]
          + v * rows[..., C_E])
    dev, dt = rows.device, rows.dtype
    x = (torch.arange(STRIP_W, device=dev) - STRIP_W // 2).to(dt)
    d = torch.arange(STRIP_H, device=dev).to(dt)[:, None]
    ex = lambda c: c[..., None]                                 # noqa: E731
    x0 = ex(cA) * (x * x) + ex(cD) * x + ex(cF)                # (S, E, 32)
    x1 = ex(cB) * x + ex(cE)
    x2 = ex(cC)
    h = STRIP_H // 2
    a0 = (x0 - h * x1 + (h * h) * x2)[..., None, :]            # (S, E, 1, 32)
    b0 = (x1 - STRIP_H * x2)[..., None, :]
    c0 = x2[..., None, :]
    ar = torch.exp2(a0 + d * (b0 + d * c0))                    # (S, E, 32, 32)
    zero = torch.zeros((), dtype=dt, device=dev)
    return torch.where(ar >= ALPHA_EPS, torch.clamp_max(ar, ALPHA_MAX), zero)


def _block(table, idx, count, sc, sr, out_ch: int):
    """(S, out_ch + 1, 1024) of a block of strips: channels, then the
    transmittance behind the last entry."""
    rows = table[idx.long()]                                   # (S, E, 16)
    live = (torch.arange(idx.shape[1], device=idx.device)[None, :]
            < count[:, None])[..., None, None]
    a = torch.where(live, _alpha(rows, sc, sr), 0.0).flatten(2)  # (S, E, P)
    keep = torch.cumprod(1.0 - a, dim=1)
    tin = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], dim=1)
    acc = torch.einsum("sep,sec->scp", a * tin, rows[..., C_R:C_R + out_ch])
    return torch.cat([acc, keep[:, -1:]], dim=1)


def composite(table, idx, count, height: int, width: int, out_ch: int = 7,
              block: int = 16):
    """(out_ch + 1, height, width): the composited channels and, last, the
    transmittance left behind every entry. table (N+1, 16), idx (Ns, CS),
    count (Ns,). `block` strips are composited at a time, each block
    recomputed in the backward rather than kept (`checkpoint`)."""
    nrows, ncols = num_strips(height, width)
    ns = nrows * ncols
    sid = torch.arange(ns, device=table.device)
    counts = count.tolist()
    grad = torch.is_grad_enabled() and table.requires_grad
    parts = []
    for s0 in range(0, ns, block):
        s1 = min(ns, s0 + block)
        e = max(1, max(counts[s0:s1]))
        args = (table, idx[s0:s1, :e], count[s0:s1],
                (sid[s0:s1] % ncols).to(table.dtype)[:, None],
                (sid[s0:s1] // ncols).to(table.dtype)[:, None], out_ch)
        parts.append(checkpoint(_block, *args, use_reentrant=False) if grad
                     else _block(*args))
    planes = torch.cat(parts, 0).reshape(nrows, ncols, out_ch + 1, STRIP_H,
                                         STRIP_W)
    return planes.permute(2, 0, 3, 1, 4).reshape(out_ch + 1, height, width)


@torch.no_grad()
def count_pairs(table, idx, count, height: int, width: int,
                block: int = 16) -> dict:
    """The compositor's work on these lists: (pixel, entry) pairs walked
    (every entry of a strip at each of its 1,024 pixels), of them those
    with alpha > 0, the entries listed and the list slots."""
    nrows, ncols = num_strips(height, width)
    ns = nrows * ncols
    sid = torch.arange(ns, device=table.device)
    counts = count.tolist()
    live = 0
    for s0 in range(0, ns, block):
        s1 = min(ns, s0 + block)
        e = max(1, max(counts[s0:s1]))
        rows = table[idx[s0:s1, :e].long()]
        on = (torch.arange(e, device=table.device)[None, :]
              < count[s0:s1, None])[..., None, None]
        a = _alpha(rows, (sid[s0:s1] % ncols).to(table.dtype)[:, None],
                   (sid[s0:s1] // ncols).to(table.dtype)[:, None])
        live += int(((a > 0) & on).sum())
    entries = int(count.sum())
    return {"pairs": entries * STRIP_H * STRIP_W, "live": live,
            "entries": entries, "slots": idx.numel(), "strips": ns,
            "table_rows": table.shape[0]}
