"""Parity of the LBS gather's backward (kernel K4's plain version) and of
autograd through the LBS blend and TimeNet with the JAX package, on the
CPU.

The JAX gather's VJP runs its Pallas kernel in interpret mode and splits
the cotangent into bf16 hi + lo (~2^-17 relative per value), so a table
column that collects n neighbour sites differs from the exact float32
sum by up to ~n * 2^-17 * max|g|: the gather backward is held at
2e-5 * max|g| * (most sites on one column). The blend and TimeNet are held
at a relative L2 of 1e-4 per input (float32 rounding of the same
formulas, plus that split inside the blend's backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.models import deform as jdef
from dimo_tpu.models import timenet as jtn
from dimo_tpu.ops import smallgather as jsg

from dimo_tpu_torch.io.convert import timenet_from_numpy
from dimo_tpu_torch.models import deform as tdef
from dimo_tpu_torch.ops import smallgather as tsg

from test_torch_deform import _knn_both, _knn_inputs
from test_torch_math import _timenet_leaves
from torch_parity import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.linalg.norm(np.asarray(got) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("m,k,n", [(32, 4, 1000), (512, 4, 3000)])
def test_gather_bwd_plain_matches_jax_vjp(m, k, n):
    rng = np.random.RandomState(m + n)
    table = rng.randn(11, m).astype(np.float32)
    idx = rng.randint(0, m, (k, n)).astype(np.int32)
    g = rng.randn(11, k, n).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jsg.gather_small_cols(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    got = tsg.gather_small_cols_bwd_plain(_t(g), _t(idx), m)
    hits = np.bincount(idx.reshape(-1), minlength=m).max()
    atol = 2e-5 * float(np.abs(g).max()) * hits
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol)
    # autograd through the port's gather runs the same backward
    t = _t(table).requires_grad_(True)
    tsg.gather_small_cols(t, _t(idx)).backward(_t(g))
    assert torch.equal(t.grad, got)


def test_gather_bwd_drops_out_of_range_and_is_exact():
    rng = np.random.RandomState(4)
    idx = rng.randint(0, 16, (3, 200)).astype(np.int32)
    idx[0, :7] = 16                      # outside [0, M): adds nothing
    idx[1, :5] = -1
    g = rng.randn(11, 3, 200).astype(np.float32)
    got = tsg.gather_small_cols_bwd_plain(_t(g), _t(idx), 16).numpy()
    ref = np.zeros((11, 16), np.float64)
    for s, j in enumerate(idx.reshape(-1)):
        if 0 <= j < 16:
            ref[:, j] += g.reshape(11, -1)[:, s]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("local_frame", [True, False])
def test_lbs_blend_grads_match_jax_vjp(local_frame):
    n, m = 600, 32
    xyz, c, act = _knn_inputs(n, m, 21)
    rng = np.random.RandomState(23)
    rot = rng.randn(n, 4).astype(np.float32)
    d_xyz = (rng.randn(m, 3) * 0.05).astype(np.float32)
    d_rot = (np.array([1.0, 0, 0, 0]) + rng.randn(m, 4) * 0.3).astype(np.float32)
    c_rad = np.exp(rng.uniform(-3, -1.5, (m, 1))).astype(np.float32)
    (jd, ji), (td, ti) = _knn_both(xyz, c, act)
    ins = (xyz, rot, c, d_xyz, d_rot, c_rad)
    cot_p = rng.randn(n, 3).astype(np.float32)
    cot_r = rng.randn(n, 4).astype(np.float32)

    def f_j(*a):
        return jdef.lbs_blend(*a, ji, jd, local_frame=local_frame)

    refs = jax.jit(lambda c, *a: jax.vjp(f_j, *a)[1](c))(
        (jnp.asarray(cot_p), jnp.asarray(cot_r)), *map(jnp.asarray, ins))
    t_ins = [_t(a).requires_grad_(True) for a in ins]
    pts, rq = tdef.lbs_blend(*t_ins, ti, td, local_frame=local_frame)
    torch.autograd.backward([pts, rq], [_t(cot_p), _t(cot_r)])
    names = ("xyz", "rotation", "c_xyz", "d_xyz", "d_rot", "c_radius")
    for name, t_in, ref in zip(names, t_ins, refs):
        assert _rel(t_in.grad.numpy(), ref) <= 1e-4, (name, _rel(t_in.grad, ref))


def test_timenet_grads_match_jax_vjp():
    leaves = _timenet_leaves(8, 5)
    net = timenet_from_numpy(leaves, device="cpu")
    rng = np.random.RandomState(6)
    pts = rng.uniform(-0.5, 0.5, (3, 48, 3)).astype(np.float32)
    ts = rng.rand(3, 1, 1).astype(np.float32)
    lat = rng.randn(8).astype(np.float32)
    cot_x = rng.randn(3, 48, 3).astype(np.float32)
    cot_q = rng.randn(3, 48, 4).astype(np.float32)

    def f_j(params, p, lt):
        return jtn.apply_timenet(params, p, jnp.asarray(ts), lt)

    jparams = {k: jnp.asarray(v) for k, v in leaves.items()}
    g_params, g_pts, g_lat = jax.jit(lambda c, *a: jax.vjp(f_j, *a)[1](c))(
        (jnp.asarray(cot_x), jnp.asarray(cot_q)), jparams, jnp.asarray(pts),
        jnp.asarray(lat))
    p_t = _t(pts).requires_grad_(True)
    l_t = _t(lat).requires_grad_(True)
    dx, dq = net(p_t, _t(ts), l_t)
    torch.autograd.backward([dx, dq], [_t(cot_x), _t(cot_q)])
    assert _rel(p_t.grad, g_pts) <= 1e-4
    assert _rel(l_t.grad, g_lat) <= 1e-4
    layers = {f"trunk_{i}": net.trunk[i] for i in range(len(net.trunk))}
    layers.update(pts_0=net.pts_0, pts_1=net.pts_1, rot_0=net.rot_0,
                  rot_1=net.rot_1)
    for name, lin in layers.items():
        assert _rel(lin.weight.grad.T, g_params[f"{name}_w"]) <= 1e-4, name
        assert _rel(lin.bias.grad, g_params[f"{name}_b"]) <= 1e-4, name
