"""The power cut of the tile compositor (kernels K8 and K9), on the CPU.

K9 skips a (pixel, slab entry) pair for a warp whose pixels all have a
power below `composite_tiles.POWER_CUT`, K8 an entry for a thread whose
four pixels all do. That changes no bit of the result only if float32 exp
there is below the 1/255 alpha cut, so that alpha is exactly 0, T is
divided by exactly 1 and the pair adds exactly 0 to every sum. These
tests pin the cut and the layout's constants against their copies in
`csrc/composite_tiles.cu`, and that the plain versions give such an
entry no weight: the image at each channel count and every other slot's
gradient stay equal bit for bit.
"""
import math
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


def test_power_cut_gives_alpha_exactly_zero():
    cut = torch.tensor(tct.POWER_CUT, dtype=torch.float32)
    eps = torch.tensor(tct.ALPHA_EPS, dtype=torch.float32)
    assert tct.POWER_CUT < math.log(1.0 / 255.0)
    assert float(torch.exp(cut)) < float(eps)
    # every float32 power below the cut, down to where exp underflows
    p = torch.linspace(-100.0, tct.POWER_CUT, 100_001, dtype=torch.float32)
    p = torch.cat([p, torch.nextafter(cut, torch.tensor(-1e9))[None]])
    assert bool((torch.exp(p) < eps).all())


def test_kernel_constants_match_the_wrapper():
    def const(name):
        m = re.search(rf"constexpr (?:int|float) {name} = (-?[0-9.e-]+)f?;",
                      CSRC)
        assert m, name
        return float(m.group(1))

    assert const("kPowerCut") == tct.POWER_CUT
    assert ttiles.TILE_H // const("kGroupRows") == tct.GROUPS
    # K8: a thread owns COLS columns of one row, a block one row group
    assert const("kCols") == tct.COLS
    assert re.search(r"constexpr int kFwdThreads = kTileW \* kGroupRows / "
                     r"kCols;", CSRC)
    for name in ("REL", "ABS", "DET", "GROW", "PAD", "FAR"):
        assert const("kBox" + name.title()) == getattr(tct, "BOX_" + name)


def _slab(cap, seed):
    """One 32 x 128 tile's slab of `cap` Gaussians inside it (tile-local
    centres, conics of 2-6 px, opacities 0.3-0.9, random colours)."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((cap, ttiles.ATTR_DIM), np.float32)
    rows[:, ttiles.A_MX] = rng.uniform(0, 128, cap)
    rows[:, ttiles.A_MY] = rng.uniform(0, 32, cap)
    sig = rng.uniform(2, 6, cap)
    rows[:, ttiles.A_CA] = 1 / sig ** 2
    rows[:, ttiles.A_CB] = rng.uniform(-0.3, 0.3, cap) / sig ** 2
    rows[:, ttiles.A_CC] = 1 / sig ** 2
    rows[:, ttiles.A_OP] = rng.uniform(0.3, 0.9, cap)
    rows[:, ttiles.A_R:ttiles.A_R + tct.OUT_CH] = rng.rand(cap, tct.OUT_CH)
    return torch.from_numpy(rows)


def test_an_entry_below_the_cut_changes_nothing():
    live = _slab(12, 3)
    # the same Gaussian far outside the tile: its power is below the cut
    # at every pixel, by a margin
    dead = live[5].clone()
    dead[ttiles.A_MX] = 400.0
    packed = torch.cat([live[:5], dead[None], live[5:]])[None]
    counts = torch.tensor([[packed.shape[1]]], dtype=torch.int32)
    k = tct._coeffs(packed, 1)
    x, y = tct._pixel_axes(packed)
    _, ar = tct._alpha(k, 5, x, y, torch.ones(1, 1, 1, dtype=torch.bool))
    assert float(ar.max()) < math.exp(tct.POWER_CUT) / 100
    out, tfin = tct.composite_tiles_plain(packed, counts, 32, 128)
    ref_out, ref_tfin = tct.composite_tiles_plain(
        live[None], torch.tensor([[12]], dtype=torch.int32), 32, 128)
    assert torch.equal(out, ref_out) and torch.equal(tfin, ref_tfin)
    gout = torch.from_numpy(
        np.random.RandomState(4).randn(8, 32, 128).astype(np.float32))
    got = tct.composite_tiles_bwd_plain(packed, counts, tfin, gout)
    ref = tct.composite_tiles_bwd_plain(
        live[None], torch.tensor([[12]], dtype=torch.int32), ref_tfin, gout)
    assert ref[0].abs().amax(0)[:13].gt(0).all()
    assert torch.equal(torch.cat([got[0, :5], got[0, 6:]]), ref[0])
    assert not got[0, 5].any()


@pytest.mark.parametrize("out_ch", [3, 4, 7])
def test_an_entry_below_the_cut_leaves_its_pixels_bit_equal(out_ch):
    live = _slab(12, 5)
    counts = torch.tensor([[13]], dtype=torch.int32)
    ref_out, ref_t = tct.composite_tiles_plain(
        live[None], torch.tensor([[12]], dtype=torch.int32), 32, 128, out_ch)
    x, y = tct._pixel_axes(live)
    # a Gaussian far outside the tile (below the cut at every pixel), then
    # one of 1 px whose power crosses the cut inside the tile
    far, small = live[4].clone(), live[4].clone()
    far[ttiles.A_MX] = 400.0
    small[ttiles.A_MX], small[ttiles.A_MY] = 61.3, 17.6
    small[ttiles.A_CA] = small[ttiles.A_CC] = 1.0
    small[ttiles.A_CB] = 0.1
    for extra, everywhere in ((far, True), (small, False)):
        packed = torch.cat([live[:4], extra[None], live[4:]])[None]
        power = tct._power(tct._coeffs(packed, 1), 4, x, y)[0]
        below = power < tct.POWER_CUT
        assert bool(below.all()) == everywhere and bool(below.any())
        out, tfin = tct.composite_tiles_plain(packed, counts, 32, 128, out_ch)
        same = (out == ref_out).all(0) & (tfin == ref_t)
        assert bool(same[below].all())
        if not everywhere:
            assert not bool(same[~below].all())   # the entry shows above it
