"""Parity of the port's compositor backward (kernel K3's plain version),
`gather_rows`' backward and autograd through projection and `coef_table`
with the JAX package, on the CPU.

The JAX side runs its Pallas compositor VJP in interpret mode (forced by
tests/conftest.py) on per-buffer slabs: `coef_table -> build_buffers ->
composite_strips -> reassemble`, differentiated with `jax.vjp` under a
seeded cotangent on all eight planes. Tolerances:
  * plain backward vs torch.autograd of `composite_strips_plain`: 1e-5 of
    each lane's max |grad| (division replay of T vs the forward's chain;
    measured <= 2e-6);
  * port vs JAX: 1e-4 of each lane's max |grad| (the reference sums the
    quadratic and the per-entry reductions through bf16-split matmuls;
    measured <= 1.1e-5). A row whose entry sits within rounding of the
    1/255 alpha cut at some pixel may differ by that pixel's share; at
    most two such rows are allowed, and none occurs in these scenes.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops.rasterizer import gather as jgather
from dimo_tpu.ops.rasterizer import projection as jproj
from dimo_tpu.ops.rasterizer import strips as jstrips
from dimo_tpu.ops.rasterizer.composite_strips import composite_strips as j_cs

from dimo_tpu_torch.ops.rasterizer import composite_strips as tcs
from dimo_tpu_torch.ops.rasterizer import gather as tgather
from dimo_tpu_torch.ops.rasterizer import projection as tproj
from dimo_tpu_torch.ops.rasterizer import strips as tstrips
from dimo_tpu_torch.ops.rasterizer.api import camera_tensors

from test_torch_composite import CAM, scene
from torch_parity import one_torch_thread  # noqa: F401

COEF_LANES = 13          # 6 coefficients + 7 channels; ids carry no grad


def _t(a):
    return torch.from_numpy(np.array(a))


def _lanes_close(got, ref, tol, what, max_bad_rows=0):
    """|got - ref| <= tol * (each lane's max |ref|) on the first 13 lanes,
    except on at most max_bad_rows rows."""
    got, ref = np.asarray(got)[..., :COEF_LANES], np.asarray(ref)[..., :COEF_LANES]
    scale = np.abs(ref).reshape(-1, COEF_LANES).max(axis=0)
    assert (scale > 0).all(), (what, scale)
    bad = (np.abs(got - ref) > tol * scale).reshape(-1, COEF_LANES).any(axis=1)
    assert bad.sum() <= max_bad_rows, (what, int(bad.sum()),
                                       float((np.abs(got - ref) / scale).max()))


@functools.lru_cache(maxsize=None)
def _lists(width, height):
    """The reference's projected inputs, table and lists of a 500-Gaussian
    scene at capacity 128."""
    @jax.jit
    def make(*g):
        p = jproj.project(*g, jnp.asarray(CAM.world_view),
                          jnp.asarray(CAM.full_proj), jnp.asarray(CAM.campos),
                          CAM.tan_fovx, CAM.tan_fovy, width, height)
        lists = jstrips.build_strip_lists(p.mean2d, p.cull_radius, p.depth,
                                          p.in_frustum, height, width, 128)
        ins = (p.mean2d, p.conic, g[3], p.color, p.depth, p.normal)
        return ins, jstrips.coef_table(*ins, height, width), lists

    return make(*map(jnp.asarray, scene(500, 1)))


@pytest.mark.parametrize("width,height", [(128, 64), (256, 256)])
def test_plain_backward_matches_autograd_of_plain_forward(width, height):
    _, table, lists = _lists(width, height)
    idx, count = _t(lists.idx), _t(lists.count)
    cot = torch.from_numpy(
        np.random.RandomState(7).randn(8, height, width).astype(np.float32))
    tab = _t(table).requires_grad_(True)
    out = tcs.composite_strips_plain(tab, idx, count, height, width)
    out.backward(cot)
    dslot = tcs.composite_strips_bwd_plain(_t(table), idx, count,
                                           out[-1].detach(), cot)
    got = tgather.gather_rows_bwd(dslot, idx, table.shape[0])
    _lanes_close(got, tab.grad, 1e-5, "plain vs autograd")
    # by contract: zero on the id lanes and past each strip's count
    assert torch.all(dslot[..., COEF_LANES:] == 0)
    past = torch.arange(idx.shape[1])[None, :] >= count[:, None]
    assert torch.all(dslot[past] == 0)
    assert float(dslot.abs().max()) > 0


@pytest.mark.parametrize("width,height", [(128, 64), (256, 256)])
def test_table_grad_matches_jax_vjp(width, height):
    """coef_table -> compositor, differentiated into the table and into
    coef_table's inputs (mean2d, conic, opacity, colour, depth, normal)."""
    ins, table, lists = _lists(width, height)
    cot = np.random.RandomState(5).randn(8, height, width).astype(np.float32)

    def f(tab):
        bufs = jstrips.build_buffers(tab, lists, height, width)
        out = j_cs(bufs.slabs, bufs.evalid, bufs.count)
        return jstrips.reassemble(out, bufs.order, height, width)

    @jax.jit
    def vjps(tab, c, *a):
        (dtab,) = jax.vjp(f, tab)[1](c)
        tc = lambda *x: jstrips.coef_table(*x, height, width)  # noqa: E731
        return dtab, jax.vjp(tc, *a)[1](dtab)

    dtab_ref, refs = vjps(table, jnp.asarray(cot), *ins)

    t_ins = [_t(a).requires_grad_(True) for a in ins]
    tab = tstrips.coef_table(*t_ins, height, width)
    tab.retain_grad()
    out = tcs.composite_strips(tab, _t(lists.idx), _t(lists.count), height,
                               width)
    out.backward(torch.from_numpy(cot))
    n = table.shape[0] - 1                     # the dummy row is a constant
    _lanes_close(tab.grad[:n], np.asarray(dtab_ref)[:n], 1e-4, "table grad",
                 max_bad_rows=2)
    for name, t_in, ref in zip(("mean2d", "conic", "opacity", "color",
                                "depth", "normal"), t_ins, refs):
        ref = np.asarray(ref)
        rel = np.linalg.norm(t_in.grad.numpy() - ref) / np.linalg.norm(ref)
        assert rel <= 1e-4, (name, rel)


def test_projection_grads_match_jax_vjp():
    """Autograd through `project` (EWA covariance, conic, SH colour with
    its clamp at 0, camera-facing normal) against `jax.vjp`, under a
    seeded cotangent on every differentiable output."""
    width, height = 128, 64
    g = list(scene(400, 3))
    g[4][:3] = -0.5 / 0.28209479177387814   # colour exactly 0: the clamp tie
    wv, fp, cp = (np.asarray(a) for a in (CAM.world_view, CAM.full_proj,
                                          CAM.campos))
    fields = ("mean2d", "depth", "conic", "color", "normal")

    def f_j(*a):
        p = jproj.project(*a, jnp.asarray(wv), jnp.asarray(fp),
                          jnp.asarray(cp), CAM.tan_fovx, CAM.tan_fovy, width,
                          height)
        return tuple(getattr(p, k) for k in fields)

    outs = f_j(*map(jnp.asarray, g))
    rng = np.random.RandomState(9)
    cots = tuple(jnp.asarray(rng.randn(*o.shape).astype(np.float32))
                 for o in outs)
    refs = jax.jit(lambda c, *a: jax.vjp(f_j, *a)[1](c))(
        cots, *map(jnp.asarray, g))

    ins = [_t(a).requires_grad_(True) for a in g]
    p = tproj.project(*ins, *camera_tensors(CAM, "cpu"), float(CAM.tan_fovx),
                      float(CAM.tan_fovy), width, height)
    torch.autograd.backward([getattr(p, k) for k in fields],
                            [_t(c) for c in cots])
    for name, t_in, ref in zip(("means", "scales", "quats", "opacity", "sh"),
                               ins, refs):
        ref = np.asarray(ref)
        got = (t_in.grad if t_in.grad is not None
               else torch.zeros_like(t_in)).numpy()
        rel = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert rel <= 1e-4, (name, rel)
    assert float(np.abs(p.color[:3].detach().numpy()).max()) == 0.0
    # the SH rows whose colour is exactly 0 see the tie's half slope
    np.testing.assert_allclose(ins[4].grad[:3].numpy(),
                               np.asarray(refs[4])[:3], rtol=1e-5, atol=1e-7)


def test_gather_rows_backward_matches_jax_segment_sum():
    rng = np.random.RandomState(2)
    attrs = rng.randn(40, 16).astype(np.float32)
    idx = rng.randint(0, 40, (12, 30)).astype(np.int32)
    g = rng.randn(12, 30, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jgather.gather_rows(a, jnp.asarray(idx)),
                     jnp.asarray(attrs))
    (ref,) = vjp(jnp.asarray(g))
    a = _t(attrs).requires_grad_(True)
    tgather.gather_rows(a, _t(idx)).backward(_t(g))
    # the reference differences a running cumsum (rounding ~ eps * |cumsum|)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(g).sum(axis=(0, 1)).max()))


def test_early_exit_variants_are_forward_only():
    _, table, lists = _lists(128, 64)
    tab = _t(table).requires_grad_(True)
    for ch in (3, 4):
        with pytest.raises(ValueError, match="forward only"):
            tcs.composite_strips(tab, _t(lists.idx), _t(lists.count), 64, 128,
                                 out_ch=ch)
        with torch.no_grad():
            out = tcs.composite_strips(tab, _t(lists.idx), _t(lists.count),
                                       64, 128, out_ch=ch)
        assert out.shape == (ch + 1, 64, 128) and not out.requires_grad
