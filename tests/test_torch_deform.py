"""Parity of the port's KNN, LBS column gather (kernel K2's plain version)
and LBS blend with the JAX package, on the CPU.

The JAX gather runs its Pallas kernel in interpret mode and returns the
bf16 hi + lo split of each value (~2^-17 relative error); the port's
gather is exact, so gathers are compared at atol = 2e-5 * max|table|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.models import deform as jdef
from dimo_tpu.models import gaussians as JG
from dimo_tpu.models import renderer as jren
from dimo_tpu.ops import smallgather as jsg

from dimo_tpu_torch.models import deform as tdef
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.models import renderer as tren
from dimo_tpu_torch.ops import smallgather as tsg
from torch_parity import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _knn_inputs(n, m, seed, n_inactive=0):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    c = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    c[1] = c[0]                       # duplicate control point: a tie
    act = np.ones((m,), bool)
    act[m - n_inactive:] = False
    return xyz, c, act


def _knn_both(xyz, c, act):
    jp = JG.GaussianParams(xyz=jnp.asarray(xyz), features_dc=None,
                           features_rest=None, scaling=None, rotation=None,
                           opacity=None, c_xyz=jnp.asarray(c), c_radius=None,
                           r=None, latent={}, timenet={})
    ja = JG.GaussianAux(active=None, c_active=jnp.asarray(act),
                        max_radii2d=None, xyz_grad_accum=None, denom=None)
    tp = TG.GaussianParams(xyz=_t(xyz), features_dc=None, features_rest=None,
                           scaling=None, rotation=None, opacity=None,
                           c_xyz=_t(c), c_radius=None, r=None, latent={},
                           timenet=None)
    ta = TG.GaussianAux(active=None, c_active=_t(act), max_radii2d=None,
                        xyz_grad_accum=None, denom=None)
    return jren.find_knn(jp, ja), tren.find_knn(tp, ta)


@pytest.mark.parametrize("n,m,n_inactive", [(500, 32, 0), (700, 64, 9)])
def test_find_knn_matches_jax(n, m, n_inactive):
    xyz, c, act = _knn_inputs(n, m, n + m, n_inactive)
    (jd, ji), (td, ti) = _knn_both(xyz, c, act)
    assert ti.dtype == torch.int32 and ti.shape == (4, n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,case", [
    pytest.param(32, "base", id="32"),
    pytest.param(512, "base", id="512"),
    # the inputs the card's kernel takes down its other paths: a ragged
    # last block, an idx view one element off 16-byte alignment, and
    # indices -1 and M, all read as zeros
    pytest.param(512, "ragged", id="512-ragged"),
    pytest.param(512, "offset", id="512-offset"),
    pytest.param(512, "range", id="512-range"),
])
def test_gather_small_cols_matches_jax(m, case):
    rng = np.random.RandomState(m)
    table = rng.randn(11, m).astype(np.float32)
    n = 1001 if case == "ragged" else 1000
    idx = rng.randint(0, m, (4, n)).astype(np.int32)
    idx[0, :5] = m                    # out of range -> zeros on both sides
    if case == "range":
        idx[1, :7] = -1
        idx[2, 3:9] = m
    idx_t = _t(idx)
    if case == "offset":              # a view at a storage offset of one
        idx = idx.reshape(-1)
        idx_t = _t(np.concatenate([[0], idx]).astype(np.int32))[1:]
        assert idx_t.storage_offset() == 1
    out_t = tsg.gather_small_cols(_t(table), idx_t)
    out_j = jsg.gather_small_cols(jnp.asarray(table), jnp.asarray(idx))
    assert out_t.shape == (11, *idx.shape)
    atol = 2e-5 * float(np.abs(table).max())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=atol)
    flat = idx.reshape(-1)
    ok = (flat >= 0) & (flat < m)
    got = out_t.reshape(11, -1).numpy()
    assert (got[:, ~ok] == 0).all() and (~ok).sum() >= 5
    # the plain version is the exact gather
    np.testing.assert_array_equal(got[:, ok], table[:, flat[ok]])


def test_knn_weights_match_jax():
    rng = np.random.RandomState(11)
    dist = rng.uniform(0, 0.3, (4, 300)).astype(np.float32)
    rad = np.exp(rng.uniform(-6, -1, (4, 300))).astype(np.float32)
    rad[0, :3] = 0.0                  # r^2 floor binds
    np.testing.assert_allclose(
        tdef.knn_weights(_t(dist), _t(rad)).numpy(),
        np.asarray(jdef.knn_weights(jnp.asarray(dist), jnp.asarray(rad))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("local_frame", [True, False])
def test_lbs_blend_matches_jax(local_frame):
    n, m = 600, 32
    xyz, c, act = _knn_inputs(n, m, 21)
    rng = np.random.RandomState(22)
    rot = rng.randn(n, 4).astype(np.float32)
    d_xyz = (rng.randn(m, 3) * 0.05).astype(np.float32)
    # TimeNet-like rotation residuals around identity (random quaternions
    # from both hemispheres cancel in the raw blend, and the final
    # normalisation then amplifies the reference's bf16 gather error)
    d_rot = (np.array([1.0, 0, 0, 0]) + rng.randn(m, 4) * 0.3).astype(np.float32)
    d_rot[2] = 1e-5                   # near-zero quaternion: norm floor binds
    c_rad = np.exp(rng.uniform(-4, -2, (m, 1))).astype(np.float32)
    (jd, ji), (td, ti) = _knn_both(xyz, c, act)
    pts_j, rot_j = jdef.lbs_blend(
        jnp.asarray(xyz), jnp.asarray(rot), jnp.asarray(c), jnp.asarray(d_xyz),
        jnp.asarray(d_rot), jnp.asarray(c_rad), ji, jd, local_frame=local_frame)
    pts_t, rot_t = tdef.lbs_blend(
        _t(xyz), _t(rot), _t(c), _t(d_xyz), _t(d_rot), _t(c_rad), ti, td,
        local_frame=local_frame)
    # gathered inputs differ by the JAX bf16 split (2e-5 * max|table|)
    scale = max(float(np.abs(c).max()), float(np.abs(d_rot).max()), 1.0)
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), rtol=0,
                               atol=2e-5 * scale)
