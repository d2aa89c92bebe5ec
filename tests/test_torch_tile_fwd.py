"""The tile compositor's forward (kernel K8) skips, on the CPU.

K8 gives a thread four columns of one row of a tile. Per slab entry it
skips the entry when its pixels all lie outside the entry's box
(`entry_box` in `csrc/composite_tiles.cu`, `composite_tiles.entry_box`
its plain version); otherwise it forms the row's power terms
q1 = cB y + cD and q0 = (cC y + cE) y + cF once, then the power
(cA x + q1) x + q0 of each of its pixels, and skips the entry when all
four powers lie below `composite_tiles.POWER_CUT` (pinned with K8's
other constants by `test_torch_tile_cut.py`). That is bit-exact only if
the split keeps the plain version's ops in their order and no pixel at
or above the cut lies outside the box. These tests pin the `.cu`'s split
and its bits against the plain version's power, and the box on hard
Gaussians.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dimo_tpu_torch.ops.rasterizer import composite_tiles as tct
from dimo_tpu_torch.ops.rasterizer import tiles as ttiles

from torch_parity import one_torch_thread  # noqa: F401

CSRC = (Path(tct.__file__).resolve().parents[2] / "csrc"
        / "composite_tiles.cu").read_text()


def _row_split_power(c6: np.ndarray) -> np.ndarray:
    """The power of coefficients c6 (6,) float32 at every pixel of a
    32 x 128 tile, as K8 forms it: `tile_row_terms` once per row, then
    `row_power` per pixel, each float32 op rounded on its own."""
    f = np.float32
    ca, cb, cc, cd, ce, cf = (f(v) for v in c6)
    out = np.empty((ttiles.TILE_H, ttiles.TILE_W), np.float32)
    x = np.arange(ttiles.TILE_W, dtype=np.float32)
    for row in range(ttiles.TILE_H):
        y = f(row)
        q1 = f(cb * y) + cd
        q0 = f(f(f(cc * y) + ce) * y) + cf
        out[row] = (f(ca) * x + q1) * x + q0
    return out


def test_row_term_split_gives_the_plain_power_bit_for_bit():
    # the kernel forms q1, q0 and the power in the order restated above
    assert "*q1 = c6[1] * y + c6[3];" in CSRC
    assert "*q0 = (c6[2] * y + c6[4]) * y + c6[5];" in CSRC
    assert "return (c0 * x + q1) * x + q0;" in CSRC
    assert re.search(r"tile_row_terms\(c6, y, &q1, &q0\);\s*"
                     r"return row_power\(c6\[0\], q1, q0, x\);", CSRC)
    rng = np.random.RandomState(0)
    nent = 64
    # coefficients of every sign over six decades, and those of real
    # Gaussians (conics of 0.5-8 px, centres in and around the tile)
    k = {n: torch.from_numpy((rng.randn(1, nent) * 10.0 ** rng.uniform(
        -3, 3, (1, nent))).astype(np.float32))
         for n in ("cA", "cB", "cC", "cD", "cE", "cF")}
    rows = np.zeros((1, nent, ttiles.ATTR_DIM), np.float32)
    rows[0, :, ttiles.A_MX] = rng.uniform(-20, 148, nent)
    rows[0, :, ttiles.A_MY] = rng.uniform(-20, 52, nent)
    sig = rng.uniform(0.5, 8.0, nent)
    rows[0, :, ttiles.A_CA] = 1 / sig ** 2
    rows[0, :, ttiles.A_CB] = rng.uniform(-0.4, 0.4, nent) / sig ** 2
    rows[0, :, ttiles.A_CC] = 1 / sig ** 2
    rows[0, :, ttiles.A_OP] = rng.uniform(0.0, 1.0, nent)
    real = tct._coeffs(torch.from_numpy(rows), 1)
    x, y = tct._pixel_axes(real["cA"])
    for coeffs in (k, real):
        for j in range(nent):
            want = tct._power(coeffs, j, x, y)[0].numpy()
            c6 = [float(coeffs[n][0, j])
                  for n in ("cA", "cB", "cC", "cD", "cE", "cF")]
            got = _row_split_power(np.array(c6, np.float32))
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


def _hard_rows(kind: str, n: int, seed: int) -> np.ndarray:
    """Slab rows of one kind of Gaussian for a 32 x 128 tile."""
    rng = np.random.RandomState(seed)
    sig = {"tiny": (0.2, 0.6), "huge": (20.0, 300.0)}.get(kind, (0.6, 8.0))
    sig = rng.uniform(*sig, n)
    rows = np.zeros((n, ttiles.ATTR_DIM), np.float32)
    rows[:, ttiles.A_MX] = rng.uniform(-4 * sig, 128 + 4 * sig)
    rows[:, ttiles.A_MY] = rng.uniform(-4 * sig, 32 + 4 * sig)
    ca = rng.uniform(0.2, 5, n) / sig ** 2
    cc = rng.uniform(0.2, 5, n) / sig ** 2
    rho = (rng.uniform(0.99, 0.99999, n) * rng.choice([-1, 1], n)
           if kind == "elongated" else rng.uniform(-0.9, 0.9, n))
    rows[:, ttiles.A_CA], rows[:, ttiles.A_CC] = ca, cc
    rows[:, ttiles.A_CB] = rho * np.sqrt(ca * cc)
    rows[:, ttiles.A_OP] = {"faint": rng.uniform(0.0035, 0.0045, n),
                            "opaque": np.ones(n)}.get(kind,
                                                      rng.uniform(0, 1, n))
    return rows


@pytest.mark.parametrize("kind", ["tiny", "huge", "elongated", "faint",
                                  "opaque", "plain"])
def test_every_pixel_at_or_above_the_cut_lies_in_the_entrys_box(kind):
    """K8 takes -inf as the power of a thread's pixels that all lie outside
    an entry's box. That is exact only if every pixel whose computed power
    reaches the cut lies inside the box; the box's margin rests on the
    computed power's rounding staying within 13 u S of the exact quadratic
    of the same inputs, which this also checks (in float64)."""
    n = 48
    rows = _hard_rows(kind, n, seed=len(kind))
    packed = torch.from_numpy(rows)[None]
    coeffs = tct._coeffs(packed, 1)
    boxes = tct.entry_box(packed, 1)[0].numpy()
    x, y = tct._pixel_axes(packed)
    xs = np.arange(ttiles.TILE_W, dtype=np.float64)[None, :]
    ys = np.arange(ttiles.TILE_H, dtype=np.float64)[:, None]
    bounded = 0
    for j in range(n):
        power = tct._power(coeffs, j, x, y)[0].numpy()
        mx = np.float32(coeffs["mx"][0, j])
        my = np.float32(coeffs["my"][0, j])
        xlo, xhi, ylo, yhi = boxes[j]
        inside = (((xs >= xlo) & (xs <= xhi)) & ((ys >= ylo) & (ys <= yhi)))
        assert not bool((power >= tct.POWER_CUT)[~inside].any()), j
        bounded += bool(np.isfinite([xlo, xhi, ylo, yhi]).all()
                        and not inside.all())
        # the rounding bound the margin is five times over
        ca, cb, cc = (float(rows[j, i])
                      for i in (ttiles.A_CA, ttiles.A_CB, ttiles.A_CC))
        lop = float(np.float32(np.log(max(rows[j, ttiles.A_OP],
                                          np.float32(tct.OP_FLOOR)))))
        dx, dy = xs - float(mx), ys - float(my)
        exact = lop - 0.5 * (ca * dx * dx + 2 * cb * dx * dy + cc * dy * dy)
        mxf, myf = float(mx), float(my)
        s = (0.5 * ca * 128 ** 2 + abs(cb) * 128 * 32 + 0.5 * cc * 32 ** 2
             + (abs(ca * mxf) + abs(cb * myf)) * 128
             + (abs(cc * myf) + abs(cb * mxf)) * 32 + 0.5 * ca * mxf ** 2
             + 0.5 * cc * myf ** 2 + abs(cb * mxf * myf) + abs(lop))
        assert np.abs(power - exact).max() <= 13 * 2.0 ** -24 * s, j
    # the test is not vacuous: most boxes leave pixels out
    assert bounded >= (n // 4 if kind in ("huge", "elongated") else n // 2)


def test_entry_box_gives_the_whole_plane_or_nothing_at_its_edges():
    """A conic that is singular or not positive definite, or a value that
    is not finite, gets the whole plane (K8 then tests every pixel's
    power); an opacity so low that lop lies below the cut less the margin
    gets an empty box (K8 skips the entry); a flat conic a box past the
    tile's edges."""
    rows = _hard_rows("plain", 9, seed=3)
    rows[8, ttiles.A_CA:ttiles.A_CC + 1] = [1e-6, 0.0, 1e-6]     # flat
    rows[0, ttiles.A_CC] = 0.0
    rows[1, ttiles.A_CB] = np.sqrt(rows[1, ttiles.A_CA]
                                   * rows[1, ttiles.A_CC])       # singular
    rows[2, ttiles.A_CA] = -0.1                                  # negative
    rows[3, ttiles.A_MX] = np.inf
    rows[4, ttiles.A_CB] = np.nan
    rows[5, ttiles.A_OP] = 0.0                                   # the dummy
    rows[6, ttiles.A_OP] = 1e-3
    rows[7, ttiles.A_OP] = 1.0
    box = tct.entry_box(torch.from_numpy(rows)[None], 1)[0].numpy()
    inf = np.float32(np.inf)
    for j in range(5):
        np.testing.assert_array_equal(box[j], [-inf, inf, -inf, inf])
    for j in (5, 6):
        np.testing.assert_array_equal(box[j], [inf, -inf, inf, -inf])
    assert np.isfinite(box[7]).all()
    assert box[7, 0] < box[7, 1] and box[7, 2] < box[7, 3]
    assert box[8, 0] < 0 and box[8, 1] > 127 and box[8, 2] < 0 \
        and box[8, 3] > 31
