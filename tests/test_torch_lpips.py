"""LPIPS (`dimo_tpu_torch/models/lpips.py`) against `dimo_tpu.models.lpips`,
on the CPU (float32 on both sides).

Same seeded weights (bit-equal), same images: the five VGG taps and the
distances within 1e-5 relative, the gradient of the summed distances with
respect to the first image within 1e-5 relative L2 (measured ~1e-6: the
two frameworks' convolutions sum in another order); the golden file
within the 2e-5 that `tests/test_lpips_text.py` holds the JAX side to;
the loaders and the fallback as the reference's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dimo_tpu.models import lpips as J

from dimo_tpu_torch.io.convert import lpips_params_from_numpy
from dimo_tpu_torch.models import lpips as T

from torch_parity import one_torch_thread  # noqa: F401

SHAPES = [(2, 3, 64, 64), (2, 3, 96, 64)]


@pytest.fixture(scope="module")
def params():
    return J.seeded_lpips_params(0), T.seeded_lpips_params(0)


def _images(shape, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_seeded_params_are_the_references_bit_for_bit(params):
    jp, tp = params
    assert jp.keys() == tp.keys()
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)


@pytest.mark.parametrize("shape", SHAPES, ids=["64x64", "96x64"])
def test_features_and_distances_match_jax(params, shape):
    jp, tp = params
    a, b = _images(shape, 0)
    scale = lambda x: (x - J._SHIFT[None, :, None, None]) / J._SCALE[  # noqa: E731
        None, :, None, None]
    fj = J.vgg_features(jp, jnp.asarray(scale(a)))
    ft = T.vgg_features(tp, torch.from_numpy(scale(a)))
    assert len(ft) == len(fj) == 5
    for k, (x, y) in enumerate(zip(ft, fj)):
        assert x.shape == y.shape, k
        assert _rel(x.numpy(), np.asarray(y)) <= 1e-5, k
    dj = np.asarray(jax.jit(J.lpips)(jp, jnp.asarray(a), jnp.asarray(b)))
    dt = T.lpips(tp, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert dt.shape == (shape[0],)
    np.testing.assert_allclose(dt, dj, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=["64x64", "96x64"])
def test_input_gradient_matches_jax(params, shape):
    jp, tp = params
    a, b = _images(shape, 1)
    gj = np.asarray(jax.jit(jax.grad(
        lambda x, y: jnp.sum(J.lpips(jp, x, y))))(jnp.asarray(a),
                                                  jnp.asarray(b)))
    x = torch.from_numpy(a).requires_grad_(True)
    T.lpips(tp, x, torch.from_numpy(b)).sum().backward()
    assert _rel(x.grad.numpy(), gj) <= 1e-5


def test_golden_vectors(params):
    path = os.path.join(os.path.dirname(__file__), "golden", "lpips_golden.npz")
    with np.load(path) as z:
        imgs1, imgs2, dist, seed = z["imgs1"], z["imgs2"], z["dist"], z["seed"]
    fn = T.random_init_lpips(int(seed), device="cpu")
    got = fn(torch.from_numpy(imgs1), torch.from_numpy(imgs2)).numpy()
    np.testing.assert_allclose(got, dist, atol=2e-5)


def test_conv_weight_gradient_is_autograds():
    """The convolution's own backward (which sets its precision) gives
    autograd's gradients for a weight that requires one, too."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 5, 9, 7).astype(np.float32))
    w = torch.from_numpy(rng.randn(6, 5, 3, 3).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 6, 9, 7).astype(np.float32))
    grads = []
    for conv in (lambda x, w: T._Conv3x3.apply(x, w, False),
                 lambda x, w: F.conv2d(x, w, padding=1)):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        torch.sum(conv(xx, ww) * g).backward()
        grads.append((xx.grad, ww.grad))
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_npz_round_trip_through_both_loaders(tmp_path, capsys):
    rng = np.random.RandomState(3)
    w = {}
    c_in = 3
    for i, (c_out, _) in enumerate(J._VGG_PLAN):
        w[f"conv{i}_w"] = rng.randn(c_out, c_in, 3, 3).astype(np.float32) * 0.1
        w[f"conv{i}_b"] = rng.randn(c_out).astype(np.float32) * 0.01
        c_in = c_out
    for k, c in enumerate(T.TAP_CHANNELS):
        w[f"lin{k}_w"] = np.abs(rng.randn(c)).astype(np.float32)
    path = str(tmp_path / "w.npz")
    np.savez(path, **w)
    a, b = _images((1, 3, 32, 32), 2)
    dj = np.asarray(J.load_lpips(path)(jnp.asarray(a), jnp.asarray(b)))
    fn = T.get_lpips(path, device="cpu")
    dt = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    assert dt[0] > 0
    loaded = lpips_params_from_numpy(dict(np.load(path)), device="cpu")
    for k, v in w.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v)
    del w["lin4_w"]
    with pytest.raises(ValueError, match="lin4_w"):
        lpips_params_from_numpy(w, device="cpu")


def test_get_lpips_random_and_off(capsys, params):
    missing = "/nonexistent/w.npz"
    assert T.load_lpips(missing, device="cpu") is None
    fn = T.get_lpips(missing, fallback="random", device="cpu")
    assert "random-VGG perceptual fallback" in capsys.readouterr().out
    a, b = _images((1, 3, 32, 32), 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(fn(ta, tb), T.lpips(params[1], ta, tb))
    np.testing.assert_allclose(
        fn(ta, tb).numpy(),
        np.asarray(J.get_lpips(missing, fallback="random")(jnp.asarray(a),
                                                            jnp.asarray(b))),
        rtol=1e-5)
    assert T.get_lpips(missing, fallback="off", device="cpu") is None
    assert "LPIPS loss disabled" in capsys.readouterr().out
