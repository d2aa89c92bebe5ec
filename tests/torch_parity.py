"""Shared helpers of the PyTorch port's parity tests: the image
comparison below, and `one_torch_thread`.

A composited pixel can differ from the reference by a step where one
list entry's alpha lies within float32 rounding of the 1/255 cut: the
two frameworks sum the power quadratic in another order, so one side
keeps the entry and the other drops it. Such a flip moves that pixel by
at most about 2/255 of the channel's magnitude, and it is rare (a few
pixels per million pixel-entry evaluations). Everything else must agree
to the stated tolerance. Callers whose scenes also hit the shifted
quadratic's float32 cancellation widen `max_px_frac` and say why.
"""
import numpy as np
import pytest
import torch

ALPHA_EPS = 1.0 / 255.0


def assert_close_except_cut_flips(got, ref, tol, what="", max_px_frac=2e-4):
    """got/ref (C, H, W): |got - ref| <= tol except on at most
    max(2, max_px_frac * H * W) pixels, where it stays within the size of
    one entry's flip at the alpha cut."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    bad_px = (err > tol).any(axis=0)
    n_bad = int(bad_px.sum())
    limit = max(2, int(max_px_frac * bad_px.size))
    assert n_bad <= limit, (what, n_bad, limit, float(err.max()))
    scale = np.maximum(np.abs(ref).reshape(ref.shape[0], -1).max(axis=1), 1.0)
    step = 2.0 * ALPHA_EPS * scale[:, None, None] + tol
    assert (err <= step).all(), (what, float(err.max()))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a test module's PyTorch ops on one intra-op thread. The plain
    versions are long chains of small ops; with several test workers on
    the machine, each op's default thread pool oversubscribes the cores
    and spins (measured: a 3 s test took 160 s beside five busy
    processes, and 24 s on one thread). Import it into a test module to
    use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
