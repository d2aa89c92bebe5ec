"""Parity of the port's strip compositor (kernel K1's plain version) and
`rasterize` with the JAX package, on the CPU.

The JAX side runs its Pallas compositor in interpret mode (forced by
tests/conftest.py) on per-buffer slabs and reassembles the planes; the
port composites straight into image layout. Tolerances:
  * composite, 7 channels: 1e-5 (same contract, same float32 formula;
    the reference sums the quadratic through a bf16-split matmul);
  * composite, 3 channels: 5e-4 against the reference's early-exit
    kernel, which stops at chunk granularity once T < 1e-4 (the bound of
    `tests/test_rasterizer.py`'s early-exit test);
  * rasterize: 1e-4 on image, alpha, depth and normal (the
    `test_rasterizer.py:41-47` tolerance; projection rounds differently).
Each allows the rare pixel where one entry's alpha sits within rounding
of the 1/255 cut (see tests/torch_parity.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops.rasterizer import rasterize as j_rasterize
from dimo_tpu.ops.rasterizer import strips as jstrips
from dimo_tpu.ops.rasterizer.composite_strips import (
    composite_strips as j_cs, composite_strips_infer as j_csi)
from dimo_tpu.utils import cameras as jcam

from dimo_tpu_torch.ops.rasterizer import rasterize as t_rasterize
from dimo_tpu_torch.ops.rasterizer import composite_strips as tcs
from dimo_tpu_torch.utils import cameras as tcam

from torch_parity import assert_close_except_cut_flips, one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def scene(n, seed, log_s=(-3.3, -2.2), spread=0.6):
    rng = np.random.RandomState(seed)
    means = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(*log_s, (n, 3))).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    sh = rng.uniform(-0.5, 0.5, (n, 1, 3)).astype(np.float32)
    return means, scales, quats, opac, sh


CAM = jcam.Camera.from_c2w(jcam.orbit_camera(10, 30, 2.0), 0.8, 0.8)


def _jax_table_lists(g, width, height, capacity):
    """The reference's coefficient table and strip lists, as numpy."""
    from dimo_tpu.ops.rasterizer import projection as jproj
    p = jproj.project(*map(jnp.asarray, g), jnp.asarray(CAM.world_view),
                      jnp.asarray(CAM.full_proj), jnp.asarray(CAM.campos),
                      CAM.tan_fovx, CAM.tan_fovy, width, height)
    lists = jstrips.build_strip_lists(p.mean2d, p.cull_radius, p.depth,
                                      p.in_frustum, height, width, capacity)
    table = jstrips.coef_table(p.mean2d, p.conic, jnp.asarray(g[3]), p.color,
                               p.depth, p.normal, height, width)
    return table, lists


@pytest.mark.parametrize("channels,width,height", [(7, 128, 64), (7, 256, 256),
                                                   (3, 256, 256)])
def test_composite_plain_matches_jax(channels, width, height):
    g = scene(500, 1)
    table, lists = _jax_table_lists(g, width, height, 128)
    bufs = jstrips.build_buffers(table, lists, height, width)
    if channels == 7:
        out = j_cs(bufs.slabs, bufs.evalid, bufs.count)
    else:
        out = j_csi(bufs.slabs, bufs.evalid, bufs.count, channels)
    ref = np.asarray(jstrips.reassemble(out, bufs.order, height, width))
    got = tcs.composite_strips(_t(table), _t(lists.idx), _t(lists.count),
                               height, width, out_ch=channels).numpy()
    assert got.shape == (channels + 1, height, width)
    assert got[-1].min() < 0.5                 # something was composited
    tol = 1e-5 if channels == 7 else 5e-4
    assert_close_except_cut_flips(got, ref, tol, f"ch{channels}")


def test_composite_dummy_rows_and_empty_strips():
    """Padded slots point at the dummy row and change nothing; a strip
    with count 0 stays transparent."""
    g = scene(300, 2)
    table, lists = _jax_table_lists(g, 128, 64, 64)
    idx, count = _t(lists.idx), _t(lists.count)
    base = tcs.composite_strips(_t(table), idx, count, 64, 128)
    count2 = count.clone()
    count2[0] = 0
    idx2 = idx.clone()
    idx2[0] = table.shape[0] - 1
    out = tcs.composite_strips(_t(table), idx2, count2, 64, 128)
    assert torch.all(out[-1, :32, :32] == 1) and torch.all(out[:-1, :32, :32] == 0)
    assert torch.equal(out[:, :, 32:], base[:, :, 32:])


def _raster_both(g, width, height, capacity, channels, valid=None):
    j = j_rasterize(*map(jnp.asarray, g), CAM, width, height, jnp.ones((3,)),
                    capacity=capacity, channels=channels,
                    valid=None if valid is None else jnp.asarray(valid))
    t = t_rasterize(*map(_t, g), tcam.Camera(*CAM), width, height,
                    torch.ones(3), capacity=capacity, channels=channels,
                    valid=None if valid is None else _t(valid))
    return j, t


@pytest.mark.parametrize("width,height", [(128, 64), (256, 256)])
def test_rasterize_matches_jax(width, height):
    g = scene(400, 3)
    valid = np.ones((400,), bool)
    valid[::13] = False
    j, t = _raster_both(g, width, height, 64, 7, valid)
    for f in ("image", "alpha", "depth", "normal"):
        assert_close_except_cut_flips(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), 1e-4, f)
    assert float(t.alpha.max()) > 0.5
    assert int(t.overflow) == int(j.overflow)
    assert int(t.overflow_max) == int(j.overflow_max)
    d = np.abs(t.radii.numpy() - np.asarray(j.radii))
    assert d.max() <= 1.0


@pytest.mark.parametrize("channels", [3, 4])
def test_rasterize_infer_channels_match_jax(channels):
    g = scene(400, 4)
    j, t = _raster_both(g, 128, 64, 64, channels)
    for f in ("image", "alpha", "depth"):
        ref = np.asarray(getattr(j, f))
        assert_close_except_cut_flips(getattr(t, f).numpy(), ref,
                                      5e-4 * max(1.0, float(np.abs(ref).max())),
                                      f)
    assert torch.all(t.normal == 0)
    if channels == 3:
        assert torch.all(t.depth == 0)
