"""Parity of the port's projection and strip/bin list construction with
the JAX package, on the CPU.

Projection: mean2d, conic, colour, normal and depth at 1e-4 relative;
the integer radii may flip by 1 px where 3*sigma sits on an ulp boundary.
Binning is held on SHARED numpy inputs (so no radius flip can turn into
a list mismatch): counts, overflow and overflow_max exactly, per-bin
membership exactly, and order exactly wherever the quantized depth keys
differ. Ties keep their emission order in the port (stable sorts); the
reference's `lax.sort` leaves their order unspecified.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops.rasterizer import projection as jproj
from dimo_tpu.ops.rasterizer import strips as jstrips
from dimo_tpu.ops.rasterizer import tiles as jtiles
from dimo_tpu.utils import cameras as jcam

from dimo_tpu_torch.ops.rasterizer import projection as tproj
from dimo_tpu_torch.ops.rasterizer import strips as tstrips
from dimo_tpu_torch.ops.rasterizer import tiles as ttiles


def _t(a):
    return torch.from_numpy(np.array(a))


def gaussians(n, seed, spread=0.6, log_s=(-3.3, -2.2)):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(*log_s, (n, 3))).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    opac = rng.uniform(0.02, 0.95, (n, 1)).astype(np.float32)
    sh = rng.uniform(-0.5, 0.5, (n, 4, 3)).astype(np.float32)
    return means, scales, quats, opac, sh


def _project_both(g, cam, width, height, sh_degree=1, valid=None):
    j = jproj.project(*map(jnp.asarray, g), jnp.asarray(cam.world_view),
                      jnp.asarray(cam.full_proj), jnp.asarray(cam.campos),
                      cam.tan_fovx, cam.tan_fovy, width, height,
                      sh_degree=sh_degree,
                      valid=None if valid is None else jnp.asarray(valid))
    t = tproj.project(*map(_t, g), _t(cam.world_view), _t(cam.full_proj),
                      _t(cam.campos), float(cam.tan_fovx),
                      float(cam.tan_fovy), width, height, sh_degree=sh_degree,
                      valid=None if valid is None else _t(valid))
    return j, t


@pytest.mark.parametrize("width,height,seed", [(128, 64, 0), (256, 256, 1)])
def test_project_matches_jax(width, height, seed):
    g = gaussians(400, seed)
    cam = jcam.Camera.from_c2w(jcam.orbit_camera(10, 30, 2.0), 0.8, 0.8)
    valid = np.ones((400,), bool)
    valid[::17] = False
    j, t = _project_both(g, cam, width, height, valid=valid)
    for f in ("mean2d", "depth", "conic", "color", "normal"):
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()), err_msg=f)
    np.testing.assert_array_equal(t.in_frustum.numpy(), np.asarray(j.in_frustum))
    for f in ("radius", "cull_radius"):
        d = np.abs(getattr(t, f).numpy() - np.asarray(getattr(j, f)))
        assert d.max() <= 1.0 and (d > 0).mean() < 0.01, f


def _scene(n, seed, width, height, r_lo, r_hi, ties=False):
    """Shared screen-space inputs: centres (some off screen), log-uniform
    radii, distinct (or heavily tied) depths."""
    rng = np.random.RandomState(seed)
    mean2d = np.stack([rng.uniform(-40, width + 40, n),
                       rng.uniform(-40, height + 40, n)], 1).astype(np.float32)
    radius = np.ceil(np.exp(rng.uniform(np.log(r_lo), np.log(r_hi), n))
                     ).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, n).astype(np.float32)
    if ties:
        depth = np.repeat(depth[: n // 4], 4)[:n]
    ok = rng.uniform(size=n) > 0.05
    return mean2d, radius, depth, ok


def _dq(mean2d, radius, depth, ok, nrows, ncols, bh, bw):
    """The port's quantized depth key of every gaussian."""
    m, r, d, o = _t(mean2d), _t(radius), _t(depth), _t(ok)
    cmin = torch.floor((m[:, 0] - r) / bw)
    cmax = torch.floor((m[:, 0] + r) / bw)
    rmin = torch.floor((m[:, 1] - r) / bh)
    rmax = torch.floor((m[:, 1] + r) / bh)
    alive = o & (r > 0) & (cmax >= 0) & (cmin <= ncols - 1) \
        & (rmax >= 0) & (rmin <= nrows - 1)
    dmax = (1 << ttiles._depth_bits_for(nrows * ncols)) - 1
    return ttiles._quantize_depth(d, alive, dmax).numpy()


def assert_lists_match(j, t, dq, capacity):
    """Exact count/overflow/membership; exact order where keys differ."""
    j_idx, j_cnt = np.asarray(j.idx), np.asarray(j.count)
    t_idx, t_cnt = t.idx.numpy(), t.count.numpy()
    assert t_idx.shape == j_idx.shape and t_idx.dtype == np.int32
    np.testing.assert_array_equal(t_cnt, j_cnt)
    assert int(t.overflow) == int(j.overflow)
    assert int(t.overflow_max) == int(j.overflow_max)
    n = len(dq)
    dq_ext = np.append(dq, -1)
    for b in range(len(t_cnt)):
        c = t_cnt[b]
        a, e = t_idx[b, :c], j_idx[b, :c]
        assert (t_idx[b, c:] == n).all() and (j_idx[b, c:] == n).all(), b
        np.testing.assert_array_equal(dq_ext[a], dq_ext[e], err_msg=str(b))
        full = c < capacity            # truncation may cut a tie run
        keys = dq_ext[a]
        for k in np.unique(keys):
            run_a, run_e = a[keys == k], e[keys == k]
            if len(run_a) == 1:
                assert run_a[0] == run_e[0], b
            elif full or k != keys[-1]:
                assert sorted(run_a) == sorted(run_e), b


@pytest.mark.parametrize("case", ["small", "medium", "big", "ties"])
def test_build_bin_lists_matches_jax(case):
    nrows, ncols, bh, bw = 6, 8, 32, 32
    n = 400
    cap = {"small": 64, "medium": 24, "big": 24, "ties": 8}[case]
    r_lo, r_hi = {"small": (1, 14), "medium": (1, 60), "big": (1, 110),
                  "ties": (1, 20)}[case]
    inp = _scene(n, {"small": 1, "medium": 2, "big": 3, "ties": 4}[case],
                 ncols * bw, nrows * bh, r_lo, r_hi, ties=case == "ties")
    mean2d, radius, depth, ok = inp
    j = jtiles.build_bin_lists(*map(jnp.asarray, inp), nrows, ncols, bh, bw,
                               cap, kr=2, kc=2)
    t = ttiles.build_bin_lists(*map(_t, inp), nrows, ncols, bh, bw, cap,
                               kr=2, kc=2)
    # the case exercises the tier it names
    foot = np.maximum(np.floor((mean2d[:, 0] + radius) / bw)
                      - np.floor((mean2d[:, 0] - radius) / bw),
                      np.floor((mean2d[:, 1] + radius) / bh)
                      - np.floor((mean2d[:, 1] - radius) / bh))
    if case == "medium":
        assert ((foot >= 2) & (foot < 5) & ok).sum() > 10
    if case == "big":
        assert ((foot >= 5) & ok).sum() > 5
    assert int(t.overflow) > 0 or case == "small"
    assert_lists_match(j, t, _dq(*inp, nrows, ncols, bh, bw), cap)


@pytest.mark.parametrize("width,height,capacity", [(128, 64, 64), (256, 256, 128)])
def test_build_strip_lists_matches_jax(width, height, capacity):
    g = gaussians(600, 5, log_s=(-4.0, -2.0))
    cam = jcam.Camera.from_c2w(jcam.orbit_camera(15, 40, 2.0), 0.8, 0.8)
    j, _ = _project_both(g, cam, width, height)
    h_pad = -(-height // 32) * 32
    w_pad = -(-width // 128) * 128
    inp = (np.asarray(j.mean2d), np.asarray(j.cull_radius),
           np.asarray(j.depth), np.asarray(j.in_frustum))
    jl = jstrips.build_strip_lists(*map(jnp.asarray, inp), h_pad, w_pad,
                                   capacity)
    tl = tstrips.build_strip_lists(*map(_t, inp), h_pad, w_pad, capacity)
    assert_lists_match(jl, tl, _dq(*inp, h_pad // 32, w_pad // 32, 32, 32),
                       capacity)
    assert int(tl.count.sum()) > 100


def test_coef_table_matches_jax():
    g = gaussians(300, 6)
    cam = jcam.Camera.from_c2w(jcam.orbit_camera(10, 30, 2.0), 0.8, 0.8)
    j, _ = _project_both(g, cam, 256, 128)
    args = [np.asarray(j.mean2d), np.asarray(j.conic), g[3],
            np.asarray(j.color), np.asarray(j.depth), np.asarray(j.normal)]
    tab_j = np.asarray(jstrips.coef_table(*map(jnp.asarray, args), 128, 256))
    tab_t = tstrips.coef_table(*map(_t, args), 128, 256).numpy()
    err = np.abs(tab_t - tab_j)
    assert (err <= 1e-5 * (np.abs(tab_j) + np.abs(tab_j).max(axis=0))).all()
