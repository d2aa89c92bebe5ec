"""Leaf functions with no caller yet, against the JAX package on the CPU:
`image_losses.tv_norm`, the Pearson depth losses, `l1_loss`, `mse_loss`;
`neighbors.knn`, `knn_self`, `ball_query`; `general.strip_symmetric`;
`cameras.OrbitCamera`.

Tolerances: values 1e-5 relative (1e-6 absolute), gradients the same,
indices exact. Self-exclusion in `knn_self` and `ball_query` is held
against the reference's search without it, its own hit dropped: the
reference's `eye * inf` is NaN off the diagonal (pinned below), and the
port masks the diagonal instead (`ROADMAP.md` Queue C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops import image_losses as JL
from dimo_tpu.ops import neighbors as JN
from dimo_tpu.utils import cameras as JC
from dimo_tpu.utils import general as JG

from dimo_tpu_torch.ops import image_losses as TL
from dimo_tpu_torch.ops import neighbors as TN
from dimo_tpu_torch.utils import cameras as TC
from dimo_tpu_torch.utils import general as TG

from torch_parity import one_torch_thread  # noqa: F401


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(ref), rtol=rtol, atol=atol)


def _value_and_grad(jfn, tfn, *arrays):
    """Both packages' values and gradients (w.r.t. the first array) of a
    scalar loss."""
    jv, jg = jax.value_and_grad(jfn)(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a) for a in arrays]
    ts[0].requires_grad_(True)
    tv = tfn(*ts)
    tv.backward()
    return (tv, jv), (ts[0].grad, jg)


_RNG = np.random.RandomState(0)
_V = _RNG.rand(2, 9, 8, 3).astype(np.float32)
_V[0, 2, 3] = _V[0, 2, 4]          # an exact tie: |x| at 0
_D = _RNG.rand(2, 12 * 11).astype(np.float32).reshape(2, 12, 11)

LOSSES = {
    "tv_l2": (lambda x: jnp.sum(JL.tv_norm(x, "l2")),
              lambda x: torch.sum(TL.tv_norm(x, "l2")), (_V,)),
    "tv_l1": (lambda x: jnp.sum(JL.tv_norm(x, "l1")),
              lambda x: torch.sum(TL.tv_norm(x, "l1")), (_V,)),
    "pearson": (JL.pearson_depth_loss, TL.pearson_depth_loss,
                (_D[0], _D[0] * 3 + _D[1] * 0.5)),
    "l1": (JL.l1_loss, TL.l1_loss, (_V, np.where(_V > 0.5, _V, 0.3))),
    "mse": (JL.mse_loss, TL.mse_loss, (_V, _V[::-1].copy())),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_image_losses_match_jax(name):
    jfn, tfn, arrays = LOSSES[name]
    (tv, jv), (tg, jg) = _value_and_grad(jfn, tfn, *arrays)
    _close(tv, jv)
    _close(tg, jg)


def test_tv_norm_refuses_other_types():
    with pytest.raises(ValueError, match="l2 or l1"):
        TL.tv_norm(torch.zeros(1, 2, 2, 1), "l3")


def test_local_pearson_matches_jax_at_its_patches():
    rng = np.random.RandomState(1)
    h, w, box, p = 40, 56, 8, 0.5
    rd = rng.rand(h, w).astype(np.float32)
    gd = (rd * 2 + rng.rand(h, w) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = JL.local_pearson_depth_loss(jnp.asarray(rd), jnp.asarray(gd), key,
                                      box_p=box, p_corr=p)
    # the reference's patch corners, drawn as it draws them
    n = max(1, int(p * (h // box) * (w // box)))
    k1, k2 = jax.random.split(key)
    x0 = np.asarray(jax.random.randint(k1, (n,), 0, max(1, h - box)))
    y0 = np.asarray(jax.random.randint(k2, (n,), 0, max(1, w - box)))
    got = TL.pearson_patches(torch.from_numpy(rd), torch.from_numpy(gd),
                             x0.tolist(), y0.tolist(), box)
    _close(got, ref)
    # the port's own draw: n corners inside the image, from its generator
    a = TL.local_pearson_depth_loss(torch.from_numpy(rd), torch.from_numpy(gd),
                                    torch.Generator().manual_seed(3), box, p)
    gen = torch.Generator().manual_seed(3)
    xs = torch.randint(0, h - box, (n,), generator=gen).tolist()
    ys = torch.randint(0, w - box, (n,), generator=gen).tolist()
    assert float(a) == float(TL.pearson_patches(
        torch.from_numpy(rd), torch.from_numpy(gd), xs, ys, box))


_P = np.random.RandomState(2).randn(60, 3).astype(np.float32)
_Q = np.random.RandomState(3).randn(40, 3).astype(np.float32)


@pytest.mark.parametrize("k", [1, 4, 8, 12])
def test_knn_matches_jax(k):
    jd, ji = JN.knn(jnp.asarray(_Q), jnp.asarray(_P), k)
    td, ti = TN.knn(torch.from_numpy(_Q), torch.from_numpy(_P), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(td, jd)


def test_knn_gradient_matches_jax():
    (tv, jv), (tg, jg) = _value_and_grad(
        lambda q: jnp.sum(JN.knn(q, jnp.asarray(_P), 4)[0]),
        lambda q: torch.sum(TN.knn(q, torch.from_numpy(_P), 4)[0]), _Q)
    _close(tv, jv)
    _close(tg, jg, atol=1e-5)


@pytest.mark.parametrize("k", [3, 10])
def test_knn_self_is_the_nearest_others(k):
    td, ti = TN.knn_self(torch.from_numpy(_P), k)
    # the reference's search of k + 1 with the point itself (distance 0,
    # first) dropped; its distances are euclidean, knn_self's squared
    jd, ji = JN.knn(jnp.asarray(_P), jnp.asarray(_P), k + 1)
    assert (np.asarray(ji)[:, 0] == np.arange(len(_P))).all()
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, 1:])
    _close(td, np.asarray(jd)[:, 1:] ** 2, atol=1e-5)
    # the reference's own knn_self gives NaN distances (eye * inf)
    assert np.isnan(np.asarray(JN.knn_self(jnp.asarray(_P), k)[0])).all()


@pytest.mark.parametrize("radius", [0.4, 0.9])
def test_ball_query_matches_jax(radius):
    jd, ji = JN.ball_query(jnp.asarray(_Q), jnp.asarray(_P), 6, radius)
    td, ti = TN.ball_query(torch.from_numpy(_Q), torch.from_numpy(_P), 6,
                           radius)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(td, jd)
    assert (ti == -1).any() and (ti >= 0).any()


def test_ball_query_excluding_self():
    td, ti = TN.ball_query(torch.from_numpy(_P), torch.from_numpy(_P), 5, 0.9,
                           exclude_self=True)
    jd, ji = JN.ball_query(jnp.asarray(_P), jnp.asarray(_P), 6, 0.9)
    ji, jd = np.asarray(ji), np.asarray(jd)
    assert (ji[:, 0] == np.arange(len(_P))).all()
    np.testing.assert_array_equal(ti.numpy(), ji[:, 1:])
    _close(td, jd[:, 1:])


def test_strip_symmetric_matches_jax():
    a = np.random.RandomState(4).randn(5, 2, 3, 3).astype(np.float32)
    cov = a + np.swapaxes(a, -1, -2)
    got = TG.strip_symmetric(torch.from_numpy(cov))
    assert got.shape == (5, 2, 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JG.strip_symmetric(cov)))


def test_orbit_camera_matches_jax():
    cams = [mod.OrbitCamera(800, 400, r=2.5, fovy=40) for mod in (JC, TC)]
    for c in cams:
        c.orbit(30, -12)
        c.scale(2)
        c.pan(5, 3, 1)
    j, t = cams
    for name in ("fovx", "campos", "pose", "view", "perspective",
                 "intrinsics", "mvp"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
