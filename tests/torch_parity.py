"""Shared comparison for the PyTorch port's image parity tests.

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
