"""The window readout of the binning (kernel K7's contract) against the
JAX package, on the CPU.

`gather_windows_plain` (what the port's `gather_windows` runs on a CPU
tensor) is held bit for bit against `dimo_tpu`'s Pallas kernel in
interpret mode, for every burst width the reference tests (1, 8 and 7,
the last forcing grid padding), on windows that start at the array end
(`starts == ND`) and windows that overrun it, and on the inputs that take
the card's kernel down its other paths: odd starts, an odd capacity, a
single bin. Then the port's
`build_bin_lists` with the readout route on against the route off
(exactly equal: the masks after the readout are shared), and against the
JAX lists on the scene of `tests/test_binning.py`'s readout test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops.rasterizer import tiles as jtiles
from dimo_tpu.ops.rasterizer import windowdma as jwd

from dimo_tpu_torch.ops.rasterizer import tiles as ttiles
from dimo_tpu_torch.ops.rasterizer import windowdma as twd

from test_binning import _scene as binning_scene
from test_torch_binning import _dq, _scene, _t, assert_lists_match
from torch_parity import one_torch_thread  # noqa: F401


def _pairs_and_starts(seed, nd, t):
    rng = np.random.RandomState(seed)
    pairs = rng.randint(-2 ** 31, 2 ** 31 - 1, (nd, 2), np.int64).astype(np.int32)
    starts = np.sort(rng.randint(0, nd + 1, t)).astype(np.int32)
    starts[-1] = nd            # a bin beyond every key: an all-padding window
    starts[-2] = nd - 3        # a window that overruns the array end
    return pairs, starts


@pytest.mark.parametrize("nburst,cap,kind", [
    pytest.param(1, 64, "random", id="1"),
    pytest.param(8, 64, "random", id="8"),
    pytest.param(7, 64, "random", id="7"),
    # what the card's kernel takes down its other paths: odd starts (8-byte
    # aligned windows), an odd capacity (no paired rows), a single bin
    pytest.param(1, 64, "odd", id="odd-starts"),
    pytest.param(1, 63, "random", id="cap63"),
    pytest.param(8, 63, "odd", id="odd-starts-cap63"),
    pytest.param(1, 64, "single", id="single-bin"),
])
def test_plain_readout_matches_jax_kernel(nburst, cap, kind):
    nd, t = (701, 24) if kind == "odd" else (700, 24)
    pairs, starts = _pairs_and_starts(nburst, nd, t)
    if kind == "odd":
        starts = np.minimum(starts | 1, nd).astype(np.int32)
        assert (starts % 2 == 1).all()
    if kind == "single":
        starts = starts[-2:-1]
    ref = np.asarray(jwd.gather_windows(jnp.asarray(pairs), jnp.asarray(starts),
                                        cap, nburst=nburst))
    got = twd.gather_windows(_t(pairs), _t(starts), cap)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (starts.shape[0], cap, 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the contract itself, from numpy
    padded = np.concatenate([pairs, np.zeros((cap, 2), np.int32)])
    want = padded[starts[:, None] + np.arange(cap)[None]]
    np.testing.assert_array_equal(got.numpy(), want)
    # the window at nd - 3 overruns the array end
    assert (got.numpy()[-1 if kind == "single" else -2, 3:] == 0).all()
    if kind != "single":
        assert (got.numpy()[-1] == 0).all()      # starts == ND


def test_wrapper_checks_its_inputs():
    pairs, starts = _pairs_and_starts(0, 50, 4)
    with pytest.raises(TypeError, match="int32"):
        twd.gather_windows(_t(pairs).long(), _t(starts), 8)
    with pytest.raises(ValueError, match=r"\(ND, 2\)"):
        twd.gather_windows(_t(pairs).reshape(-1), _t(starts), 8)
    before = twd.launches
    twd.gather_windows(_t(pairs), _t(starts), 8)
    assert twd.launches == before      # only a kernel launch counts


@pytest.mark.parametrize("case", ["small", "medium", "big", "ties"])
def test_readout_routes_give_identical_lists(case, monkeypatch):
    nrows, ncols, bh, bw = 6, 8, 32, 32
    cap = {"small": 64, "medium": 24, "big": 24, "ties": 8}[case]
    r_lo, r_hi = {"small": (1, 14), "medium": (1, 60), "big": (1, 110),
                  "ties": (1, 20)}[case]
    inp = _scene(400, {"small": 1, "medium": 2, "big": 3, "ties": 4}[case],
                 ncols * bw, nrows * bh, r_lo, r_hi, ties=case == "ties")
    monkeypatch.setattr(ttiles, "WINDMA", 0)
    off = ttiles.build_bin_lists(*map(_t, inp), nrows, ncols, bh, bw, cap)
    monkeypatch.setattr(ttiles, "WINDMA", 1)
    calls = []
    real = twd.gather_windows
    monkeypatch.setattr(twd, "gather_windows",
                        lambda *a: calls.append(1) or real(*a))
    on = ttiles.build_bin_lists(*map(_t, inp), nrows, ncols, bh, bw, cap)
    assert calls == [1]                # the route went through the readout
    for f in ("idx", "count", "overflow", "overflow_max"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert int(on.overflow) > 0 or case == "small"


@pytest.mark.parametrize("cap", [64, 8])
def test_windma_lists_match_jax_on_the_binning_tests_scene(cap, monkeypatch):
    """The scene of `tests/test_binning.py::test_windma_readout_matches_gather`
    at its capacity (64, windows overrunning the array end) and at one
    that truncates (8), both packages on their window route."""
    rng = np.random.RandomState(13)
    nrows, ncols, bh, bw = 4, 6, 32, 32
    n = 300
    inp = binning_scene(rng, n, 192, 1.0, 20.0)
    monkeypatch.setattr(jtiles, "WINDMA", 1)
    monkeypatch.setattr(ttiles, "WINDMA", 1)
    j = jtiles.build_bin_lists(*map(jnp.asarray, inp), nrows, ncols, bh, bw, cap)
    t = ttiles.build_bin_lists(*map(_t, inp), nrows, ncols, bh, bw, cap)
    assert (int(t.overflow) > 0) == (cap == 8)
    assert_lists_match(j, t, _dq(*inp, nrows, ncols, bh, bw), cap)


def test_windma_default_follows_the_reference():
    """Same knob, same default: off unless DIMO_WINDMA is set."""
    import os
    want = int(os.environ.get("DIMO_WINDMA", "0"))
    assert ttiles.WINDMA == want == jtiles.WINDMA
