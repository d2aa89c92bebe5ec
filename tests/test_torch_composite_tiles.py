"""Parity of the port's tile compositor (kernels K8 and K9 through their
plain versions), `pack_attrs` and `build_tile_lists` with the JAX package,
on the CPU.

The JAX side runs `composite_pallas.composite` in interpret mode (forced by
tests/conftest.py) on slabs gathered from its own table and lists.
Tolerances:
  * `pack_attrs`: equal; `build_tile_lists`: idx, count, overflow and
    overflow_max equal (the scenes' quantized depths are distinct within a
    tile, so the order is too);
  * composite, 7 channels and T_final, vs the reference: 1e-5 at 256x128
    and 1e-4 at 128x64, except the rare pixel where one entry's alpha sits
    within rounding of the 1/255 cut (tests/torch_parity.py). Both packages
    evaluate the EXPANDED tile-local quadratic in float32; at 128x64 this
    camera makes ~2 px Gaussians (conics ~0.3), the expanded terms reach
    ~2e3 and their rounding ~1e-4 in power: measured against a float64
    evaluation the port sits 6.0e-5 and the reference 3.8e-5 away, and 3.3e-5
    from each other (at 256x128: all below 8e-6). 1e-4 is the reference's
    own bound for this cancellation (tests/test_rasterizer.py:41-47);
  * `composite_infer` 3 and 4 channels: equal to the first planes of 7;
  * backward vs `jax.vjp` of the reference under a seeded cotangent on all
    eight planes: 1.2e-3 of each column's max |grad| (measured 9.66e-4
    at 128x64, 2.2e-5 at 256x128). The reference reduces dpower through a
    TWO-term bf16 split (~2^-16 per pixel term) into moments of the
    tile-local x, y, whose chain to the conic cancels terms of ~mx^2 *
    sum(dpower), and sits 9.63e-4 from float64 autograd itself; the port
    sums moments about each entry's own centre and sits 2.3e-5 from it.
    `test_the_gap_to_jax_vjp_is_the_references_own` asserts both, so the
    tight check of the port is the next one;
  * forward and backward vs torch.autograd in float64 through a dense
    re-statement of the contract (no tile-local expansion, no log-opacity,
    T by cumulative product), every tile of both scenes: forward 1e-4 (the
    cancellation above; measured 6.0e-5), backward 1e-4 of each column's
    max |grad| (measured 2.5e-5).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops.rasterizer import composite_pallas as jcp
from dimo_tpu.ops.rasterizer import gather as jgather
from dimo_tpu.ops.rasterizer import projection as jproj
from dimo_tpu.ops.rasterizer import tiles as jtiles

from dimo_tpu_torch.ops import rasterizer as trast
from dimo_tpu_torch.ops.rasterizer import composite_tiles as tct
from dimo_tpu_torch.ops.rasterizer import tiles as ttiles

from test_torch_composite import CAM, scene
from torch_parity import assert_close_except_cut_flips, one_torch_thread  # noqa: F401

GRAD_LANES = 13          # 6 geometry + 7 channels; radius and padding get 0
VJP_TOL = 1.2e-3         # vs jax.vjp, of each column's max |grad|
F64_TOL = 1e-4           # forward vs the float64 dense evaluation
F64_VJP_TOL = 1e-4       # backward vs float64 autograd, of the column max
# (width, height, capacity, Gaussians): 2 x 1 tiles and 4 x 2 tiles, both
# with tiles that overflow their capacity
SIZES = [(128, 64, 64, 300), (256, 128, 32, 500)]
FWD_TOL = {SIZES[0]: 1e-4, SIZES[1]: 1e-5}


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _ref(width, height, capacity, n):
    """The reference's projected inputs, attribute table, tile lists and
    slabs of an n-Gaussian scene, as numpy."""
    g = scene(n, 1)

    @jax.jit
    def make(*g):
        p = jproj.project(*g, jnp.asarray(CAM.world_view),
                          jnp.asarray(CAM.full_proj), jnp.asarray(CAM.campos),
                          CAM.tan_fovx, CAM.tan_fovy, width, height)
        lists = jtiles.build_tile_lists(p.mean2d, p.cull_radius, p.depth,
                                        p.in_frustum, height, width, capacity)
        attrs = jtiles.pack_attrs(p.mean2d, p.conic, g[3], p.color, p.depth,
                                  p.normal, radius=p.cull_radius)
        return p, attrs, lists, jgather.gather_rows(attrs, lists.idx)

    p, attrs, lists, packed = make(*map(jnp.asarray, g))
    nrows, ncols = jtiles.num_tiles(height, width)
    return dict(g=g, p=p, attrs=np.asarray(attrs), lists=lists,
                packed=np.asarray(packed),
                counts=np.asarray(lists.count).reshape(nrows, ncols))


def test_tile_constants_match_the_reference():
    for name in ("TILE_H", "TILE_W", "ATTR_DIM", "OUT_CH", "A_MX", "A_MY",
                 "A_CA", "A_CB", "A_CC", "A_OP", "A_R", "A_G", "A_B",
                 "A_DEPTH", "A_NX", "A_NY", "A_NZ", "A_RADIUS"):
        assert getattr(ttiles, name) == getattr(jtiles, name), name
    assert (trast.TILE_H, trast.TILE_W) == (32, 128)
    assert ttiles.num_tiles(64, 256) == jtiles.num_tiles(64, 256) == (2, 2)
    with pytest.raises(ValueError, match="multiple"):
        ttiles.num_tiles(64, 96)


@pytest.mark.parametrize("width,height,capacity,n", SIZES)
def test_pack_attrs_and_tile_lists_equal_the_reference(width, height,
                                                       capacity, n):
    r = _ref(width, height, capacity, n)
    p = r["p"]
    ins = [_t(a) for a in (p.mean2d, p.conic, r["g"][3], p.color, p.depth,
                           p.normal)]
    attrs = ttiles.pack_attrs(*ins, radius=_t(p.cull_radius))
    assert attrs.shape == (n + 1, 16)
    np.testing.assert_array_equal(attrs.numpy(), r["attrs"])
    assert not attrs[-1].any() and not attrs[:, 14:].any()
    blind = ttiles.pack_attrs(*ins)
    assert torch.all(blind[:n, ttiles.A_RADIUS] == 1e9) and not blind[-1].any()
    np.testing.assert_array_equal(
        blind.numpy(), np.asarray(jtiles.pack_attrs(*(jnp.asarray(a.numpy())
                                                      for a in ins))))
    lists = ttiles.build_tile_lists(_t(p.mean2d), _t(p.cull_radius),
                                    _t(p.depth), _t(p.in_frustum), height,
                                    width, capacity)
    for f in ("idx", "count", "overflow", "overflow_max"):
        np.testing.assert_array_equal(getattr(lists, f).numpy(),
                                      np.asarray(getattr(r["lists"], f)), f)
    assert int(lists.overflow) > 0 and int(lists.overflow_max) > 0
    assert int(lists.count.max()) > 8


def test_pack_attrs_is_differentiable_in_every_input():
    rng = np.random.RandomState(3)
    shapes = [(6, 2), (6, 3), (6, 1), (6, 3), (6,), (6, 3), (6,)]
    ins = [_t(rng.randn(*s).astype(np.float32)).requires_grad_(True)
           for s in shapes]
    cot = _t(rng.randn(7, 16).astype(np.float32))
    ttiles.pack_attrs(*ins[:6], radius=ins[6]).backward(cot)
    lanes = [(0, 2), (2, 5), (5, 6), (6, 9), (9, 10), (10, 13), (13, 14)]
    for t_in, (lo, hi) in zip(ins, lanes):
        np.testing.assert_array_equal(
            t_in.grad.reshape(6, -1).numpy(), cot[:6, lo:hi].numpy())


@pytest.mark.parametrize("width,height,capacity,n", SIZES)
def test_composite_plain_matches_jax(width, height, capacity, n):
    r = _ref(width, height, capacity, n)
    out_j, tfin_j = jcp.composite(jnp.asarray(r["packed"]),
                                  jnp.asarray(r["counts"]), height, width)
    out, tfin = tct.composite(_t(r["packed"]), _t(r["counts"]), height, width)
    assert out.shape == (7, height, width) and tfin.shape == (height, width)
    assert float(tfin.min()) < 0.5                # something was composited
    got = torch.cat([out, tfin[None]]).numpy()
    ref = np.concatenate([np.asarray(out_j), np.asarray(tfin_j)[None]])
    assert_close_except_cut_flips(
        got, ref, FWD_TOL[(width, height, capacity, n)], "composite")


@pytest.mark.parametrize("out_ch", [3, 4])
def test_composite_infer_equals_the_first_planes_of_seven(out_ch):
    r = _ref(*SIZES[1])
    packed, counts = _t(r["packed"]).requires_grad_(True), _t(r["counts"])
    full, tfin = tct.composite_infer(packed, counts, 128, 256, out_ch=7)
    out, tfin_c = tct.composite_infer(packed, counts, 128, 256, out_ch=out_ch)
    assert out.shape == (out_ch, 128, 256) and not out.requires_grad
    assert torch.equal(out, full[:out_ch]) and torch.equal(tfin_c, tfin)
    with pytest.raises(ValueError, match="3, 4 or 7"):
        tct.composite_infer(packed, counts, 128, 256, out_ch=5)


def test_empty_tile_and_rows_past_the_count():
    """A tile with count 0 stays transparent whatever its slab holds, and
    rows past a tile's count are never composited."""
    r = _ref(*SIZES[1])
    packed, counts = _t(r["packed"]), _t(r["counts"])
    base, tbase = tct.composite(packed, counts, 128, 256)
    c2 = counts.clone()
    c2[1, 0] = 0
    out, tfin = tct.composite(packed, c2, 128, 256)
    tile = (slice(32, 64), slice(0, 128))
    assert torch.all(tfin[tile] == 1) and torch.all(out[(slice(None),) + tile] == 0)
    keep = torch.ones(128, 256, dtype=torch.bool)
    keep[tile] = False
    assert torch.equal(out[:, keep], base[:, keep])
    # cut a full tile's count in two: the rows behind it add nothing
    full = int(torch.argmax(counts.reshape(-1)))
    c3 = counts.clone().reshape(-1)
    c3[full] //= 2
    p3 = packed.clone()
    p3[full, int(c3[full]):] = 0                  # the dummy row
    a = tct.composite(packed, c3.reshape(counts.shape), 128, 256)
    b = tct.composite(p3, counts, 128, 256)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    d = tct.composite_tiles_bwd_plain(packed, c3.reshape(counts.shape), a[1],
                                      torch.ones(8, 128, 256))
    assert not d[full, int(c3[full]):].any() and d[full, :int(c3[full])].any()


def _cols_close(got, ref, tol, what, max_bad_rows=0):
    got = np.asarray(got)[..., :GRAD_LANES].reshape(-1, GRAD_LANES)
    ref = np.asarray(ref)[..., :GRAD_LANES].reshape(-1, GRAD_LANES)
    scale = np.abs(ref).max(axis=0)
    assert (scale > 0).all(), (what, scale)
    bad = (np.abs(got - ref) > tol * scale).any(axis=1)
    assert bad.sum() <= max_bad_rows, (what, int(bad.sum()),
                                       float((np.abs(got - ref) / scale).max()))


def _cotangent(height, width):
    rng = np.random.RandomState(5)
    return (rng.randn(7, height, width).astype(np.float32),
            rng.randn(height, width).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_vjp(width, height, capacity, n):
    """`jax.vjp` of the reference's `composite` under the seeded cotangent."""
    r = _ref(width, height, capacity, n)
    g7, gt = _cotangent(height, width)
    counts_j = jnp.asarray(r["counts"])
    _, vjp = jax.vjp(lambda pk: jcp.composite(pk, counts_j, height, width),
                     jnp.asarray(r["packed"]))
    (ref,) = vjp((jnp.asarray(g7), jnp.asarray(gt)))
    return np.asarray(ref)


def _port_vjp(r, height, width, g7, gt):
    packed = _t(r["packed"]).requires_grad_(True)
    out, tfin = tct.composite(packed, _t(r["counts"]), height, width)
    torch.autograd.backward([out, tfin], [_t(g7), _t(gt)])
    return packed, out.detach(), tfin.detach()


@pytest.mark.parametrize("width,height,capacity,n", SIZES)
def test_backward_plain_matches_jax_vjp(width, height, capacity, n):
    r = _ref(width, height, capacity, n)
    g7, gt = _cotangent(height, width)
    ref = _jax_vjp(width, height, capacity, n)
    packed, _, tfin = _port_vjp(r, height, width, g7, gt)
    _cols_close(packed.grad, ref, VJP_TOL, "vs jax.vjp")
    # by contract: zero on lanes 13..15 and past each tile's count
    assert not packed.grad[..., GRAD_LANES:].any()
    past = (torch.arange(capacity)[None, :]
            >= _t(r["counts"]).reshape(-1)[:, None])
    assert not packed.grad[past].any() and packed.grad[~past].any()
    # the Function's backward is the plain VJP on (gout7, gtfin)
    again = tct.composite_tiles_bwd_plain(
        packed.detach(), _t(r["counts"]), tfin,
        torch.cat([_t(g7), _t(gt)[None]]))
    assert torch.equal(again, packed.grad)


def _dense_tile(rows, x_off, y_off):
    """One tile composited by a differentiable dense re-statement of the
    contract, in rows' dtype: power from the mean and the conic at absolute
    pixel centres, alpha = op * exp(power) cut and capped, T by a
    cumulative product. Shares no intermediate with the plain versions
    (no tile-local shift, no expanded coefficients, no log-opacity, no
    division replay)."""
    kw = dict(dtype=rows.dtype)
    xs = x_off + torch.arange(128, **kw)[None, None, :]
    ys = y_off + torch.arange(32, **kw)[None, :, None]
    e = lambda k: rows[:, k, None, None]                        # noqa: E731
    dx, dy = xs - e(ttiles.A_MX), ys - e(ttiles.A_MY)
    power = (-0.5 * (e(ttiles.A_CA) * dx * dx + e(ttiles.A_CC) * dy * dy)
             - e(ttiles.A_CB) * dx * dy)
    araw = e(ttiles.A_OP) * torch.exp(power)
    alpha = torch.where(araw >= tct.ALPHA_EPS,
                        torch.clamp(araw, max=tct.ALPHA_MAX),
                        torch.zeros((), **kw))
    t_before = torch.cat([torch.ones(1, 32, 128, **kw),
                          torch.cumprod(1.0 - alpha, dim=0)[:-1]])
    w = alpha * t_before
    out = torch.einsum("jc,jpq->cpq", rows[:, ttiles.A_R:ttiles.A_R + 7], w)
    return out, t_before[-1] * (1.0 - alpha[-1])


@functools.lru_cache(maxsize=None)
def _f64(width, height, capacity, n):
    """Every tile of the scene through `_dense_tile` in float64 and
    torch.autograd under the seeded cotangent: (out (7, H, W), tfin (H, W),
    dpacked (T, C, 16), zero past each tile's count), as numpy."""
    r = _ref(width, height, capacity, n)
    g7, gt = _cotangent(height, width)
    out = np.zeros((7, height, width))
    tfin = np.ones((height, width))
    grad = np.zeros(r["packed"].shape)
    ncols = width // 128
    for tile, cnt in enumerate(r["counts"].reshape(-1)):
        tr, tc = divmod(tile, ncols)
        px = (slice(32 * tr, 32 * tr + 32), slice(128 * tc, 128 * tc + 128))
        rows = _t(r["packed"])[tile, :cnt].double().requires_grad_(True)
        o, t = _dense_tile(rows, 128.0 * tc, 32.0 * tr)
        torch.autograd.backward(
            [o, t], [_t(g7)[(slice(None),) + px].double(), _t(gt)[px].double()])
        out[(slice(None),) + px] = o.detach().numpy()
        tfin[px] = t.detach().numpy()
        grad[tile, :cnt] = rows.grad.numpy()
    return out, tfin, grad


@pytest.mark.parametrize("width,height,capacity,n", SIZES)
def test_plain_pair_matches_float64_autograd_of_a_dense_restatement(
        width, height, capacity, n):
    """Every tile of the scene, forward and VJP, against torch.autograd
    through `_dense_tile` in float64: the plain VJP is analytic, so this
    catches a wrong derivation that both packages could only share by
    copying."""
    r = _ref(width, height, capacity, n)
    g7, gt = _cotangent(height, width)
    packed, out, tfin = _port_vjp(r, height, width, g7, gt)
    out64, tfin64, grad64 = _f64(width, height, capacity, n)
    np.testing.assert_allclose(out.numpy(), out64, rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(tfin.numpy(), tfin64, rtol=0, atol=F64_TOL)
    for tile, cnt in enumerate(r["counts"].reshape(-1)):
        _cols_close(packed.grad[tile, :cnt], grad64[tile, :cnt], F64_VJP_TOL,
                    f"tile {tile} vs float64 autograd")


def _col_err(got, ref):
    """Largest |got - ref| over the gradient lanes, each lane in units of
    its max |ref|."""
    got = np.asarray(got)[..., :GRAD_LANES].reshape(-1, GRAD_LANES)
    ref = np.asarray(ref)[..., :GRAD_LANES].reshape(-1, GRAD_LANES)
    return float((np.abs(got - ref) / np.abs(ref).max(axis=0)).max())


def test_the_gap_to_jax_vjp_is_the_references_own():
    """Which side of the `jax.vjp` comparison carries its 1e-3: the
    reference's VJP sits as far from float64 autograd as it sits from the
    port, and the port an order of magnitude nearer. So VJP_TOL is the
    reference's rounding plus margin, and the port's own error is held by
    F64_VJP_TOL."""
    ref_err, port_err, gap = [], [], []
    for size in SIZES:
        width, height = size[:2]
        truth = _f64(*size)[2]
        ref = _jax_vjp(*size)
        packed, _, _ = _port_vjp(_ref(*size), height, width,
                                 *_cotangent(height, width))
        ref_err.append(_col_err(ref, truth))
        port_err.append(_col_err(packed.grad.numpy(), truth))
        gap.append(_col_err(packed.grad.numpy(), ref))
    assert max(ref_err) <= VJP_TOL and max(port_err) <= F64_VJP_TOL
    # the reference is the noisy side: several times the port's error, and
    # within 20% of the whole gap between the two packages
    assert max(ref_err) > 5 * max(port_err)
    assert abs(max(ref_err) - max(gap)) <= 0.2 * max(gap)


def test_composite_rejects_bad_inputs_and_needs_no_graph():
    r = _ref(*SIZES[0])
    packed, counts = _t(r["packed"]), _t(r["counts"])
    with pytest.raises(ValueError, match="multiple"):
        tct.composite(packed, counts, 64, 100)
    with pytest.raises(TypeError, match="counts"):
        tct.composite(packed, counts.reshape(-1), 64, 128)
    with pytest.raises(TypeError, match="packed"):
        tct.composite(packed.double(), counts, 64, 128)
    out, _ = tct.composite(packed, counts, 64, 128)
    assert not out.requires_grad
    with torch.no_grad():
        out, _ = tct.composite(packed.clone().requires_grad_(True), counts,
                               64, 128)
    assert not out.requires_grad
