"""Parity of the port's losses, ARAP, schedules, Adam and gradient
conventions with the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
values and gradients are compared. Tolerances, each with its reason:
  * kink conventions: exact (0.5 / 1 / an equal split are exact floats);
  * SSIM, smoothness, PSNR, chamfer: rtol 1e-5 on values, relative L2
    1e-4 on gradients (float32 convolutions and sums in another order);
  * ARAP: rtol 1e-4 on the value, relative L2 1e-3 on the gradient (30
    power iterations of a 4x4 eigenproblem, rounded differently, feed
    the rigid term);
  * schedules and learning rates: rtol 1e-6 (float32 exp/log);
  * Adam: 1e-6 (the same float32 formula).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_scene
from dimo_tpu.models import deform as jdef
from dimo_tpu.models import renderer as jren
from dimo_tpu.ops import arap as jarap
from dimo_tpu.ops import image_losses as jL
from dimo_tpu.ops import neighbors as jnb
from dimo_tpu.train import optim as jopt
from dimo_tpu.train import step as jstep
from dimo_tpu.utils import schedules as jsched

from dimo_tpu_torch.io.convert import params_from_numpy
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.models import renderer as tren
from dimo_tpu_torch.ops import arap as tarap
from dimo_tpu_torch.ops import grad_conventions as gc
from dimo_tpu_torch.ops import image_losses as tL
from dimo_tpu_torch.ops import neighbors as tnb
from dimo_tpu_torch.train import optim as topt
from dimo_tpu_torch.train import step as tstep
from dimo_tpu_torch.utils import cameras as tcam
from dimo_tpu_torch.utils import schedules as tsched

from test_torch_math import jax_to_numpy
from test_torch_render import _exact_jax_gather
from torch_parity import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _both(fn_t, fn_j, *arrays):
    """(value, grads) of fn over the arrays in each package."""
    ins = [_t(a).requires_grad_(True) for a in arrays]
    v_t = fn_t(*ins)
    v_t.backward()
    v_t = v_t.detach()
    v_j, g_j = jax.jit(jax.value_and_grad(fn_j, argnums=tuple(range(len(arrays)))))(
        *map(jnp.asarray, arrays))
    return (float(v_t), [i.grad for i in ins]), (float(v_j), g_j)


# --- gradient conventions at kinks and ties (the repairs) ---------------

@pytest.mark.parametrize("case", ["clip_lo", "clip_hi", "abs0", "max_tie",
                                  "amin_ties"])
def test_kink_conventions_match_jax(case):
    x = {"clip_lo": [0.0, 0.5, -1.0], "clip_hi": [1.0, 0.5, 2.0],
         "abs0": [0.0, -2.0, 3.0], "max_tie": [0.0, 1.0, -1.0],
         "amin_ties": [2.0, 1.0, 1.0, 3.0]}[case]
    fn_t = {"clip_lo": lambda a: gc.clip(a, 0.0, 1.0).sum(),
            "clip_hi": lambda a: gc.clip(a, 0.0, 1.0).sum(),
            "abs0": lambda a: gc.abs(a).sum(),
            "max_tie": lambda a: gc.maximum(a, 0.0).sum(),
            "amin_ties": lambda a: gc.amin(a[None], dim=-1).sum()}[case]
    fn_j = {"clip_lo": lambda a: jnp.clip(a, 0.0, 1.0).sum(),
            "clip_hi": lambda a: jnp.clip(a, 0.0, 1.0).sum(),
            "abs0": lambda a: jnp.abs(a).sum(),
            "max_tie": lambda a: jnp.maximum(a, 0.0).sum(),
            "amin_ties": lambda a: jnp.min(a[None], axis=-1).sum()}[case]
    (v_t, (g_t,)), (v_j, (g_j,)) = _both(fn_t, fn_j,
                                         np.asarray(x, np.float32))
    assert v_t == v_j
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    # the kink itself: JAX's slope, which torch's own op does not give
    expect = {"clip_lo": 0.5, "clip_hi": 0.5, "abs0": 1.0, "max_tie": 0.5,
              "amin_ties": 0.5}[case]
    k = 1 if case == "amin_ties" else 0
    assert float(g_t[k]) == expect


@pytest.fixture(scope="module")
def small_scene():
    cfg_j, jp, ja, cam = _flagship_scene(n_gauss=512, n_cpts=32,
                                         latent_dim=8, seed=3)
    d = jax_to_numpy(jp, ja)
    tp, ta = params_from_numpy(d, device="cpu")
    cfg_t = TG.ModelConfig(sh_degree=0, latent_dim=8, num_latents=4,
                           capacity=512, cpt_capacity=32)
    return (cfg_j, jp, ja), (cfg_t, tp, ta), cam


def test_render_grad_at_white_pixels_matches_jax(small_scene, monkeypatch):
    """Background pixels composite to exactly 1.0 on white: the image clip
    passes half the cotangent there (jnp.clip), which the gradient of the
    background colour sees."""
    monkeypatch.setattr(jdef, "gather_small_cols", _exact_jax_gather)
    (cfg_j, jp, ja), (cfg_t, tp, ta), cam = small_scene
    w, h = 128, 64
    cot = np.random.RandomState(1).rand(3, h, w).astype(np.float32)
    bg = np.ones(3, np.float32)

    def f_j(b):
        img = jren.render(cfg_j, jp, ja, cam, 0.3, "s2", 1, w, h, b,
                          capacity=128)["image"]
        return jnp.sum(img * cot), img

    (_, img_j), g_j = jax.jit(jax.value_and_grad(f_j, has_aux=True))(
        jnp.asarray(bg))
    b_t = _t(bg).requires_grad_(True)
    img = tren.render(cfg_t, tp, ta, tcam.Camera(*cam), 0.3, "s2", 1, w, h,
                      b_t, capacity=128)["image"]
    torch.sum(img * _t(cot)).backward()
    white = np.asarray(img_j) == 1.0
    assert white.mean() > 0.3 and (img.detach().numpy() == 1.0).mean() > 0.3
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(g_j), rtol=1e-4)
    # torch.clamp would pass the whole cotangent on those pixels (where
    # T_final = 1), adding the other half of it to this gradient
    half = 0.5 * (cot * white).sum(axis=(1, 2))
    assert np.all(half > 0.2 * b_t.grad.numpy())


# --- image losses --------------------------------------------------------

def _images(seed, b=2, h=24, w=20, c=3):
    rng = np.random.RandomState(seed)
    a = rng.rand(b, h, w, c).astype(np.float32)
    b_ = np.clip(a + rng.randn(b, h, w, c).astype(np.float32) * 0.1, 0, 1)
    a[:, :6, :6] = 1.0                 # flat patches: exact-zero differences
    b_[:, :4, :4] = 1.0
    return a, b_.astype(np.float32)


def test_ssim_matches_jax():
    a, b = _images(0)
    (v_t, g_t), (v_j, g_j) = _both(tL.ssim, jL.ssim, a, b)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    for gt, gj in zip(g_t, g_j):
        assert _rel(gt, gj) <= 1e-4


@pytest.mark.parametrize("which", ["edge_aware", "bilateral"])
def test_smoothness_matches_jax(which):
    rng = np.random.RandomState(3)
    a, _ = _images(1)
    if which == "edge_aware":
        geo = rng.rand(2, 24, 20, 1).astype(np.float32) * 2 + 1
        fn_t, fn_j = tL.edge_aware_smoothness, jL.edge_aware_smoothness
    else:
        geo = rng.randn(2, 24, 20, 3).astype(np.float32)
        fn_t, fn_j = (tL.bilateral_normal_smoothness,
                      jL.bilateral_normal_smoothness)
    geo[:, :8, :8] = geo[:, :1, :1]    # flat geometry: exact-zero differences
    (v_t, g_t), (v_j, g_j) = _both(fn_t, fn_j, geo, a)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    for gt, gj in zip(g_t, g_j):
        assert _rel(gt, gj) <= 1e-4


def test_psnr_matches_jax():
    mse = np.asarray([0.02, 0.5, 1e-4], np.float32)
    np.testing.assert_allclose(tL.psnr(_t(mse)).numpy(),
                               np.asarray(jL.psnr(jnp.asarray(mse))),
                               rtol=1e-6)


def test_chamfer_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(30, 3).astype(np.float32) * 0.3
    y = rng.randn(40, 3).astype(np.float32) * 0.3
    y[1] = y[0]                        # duplicate target: tied nearest
    x[0] = y[0] + 0.01
    valid = np.ones(30, bool)
    valid[-4:] = False
    (v_t, g_t), (v_j, g_j) = _both(
        lambda a, b: tnb.chamfer_forward(a, b, _t(valid)),
        lambda a, b: jnb.chamfer_forward(a, b, jnp.asarray(valid)), x, y)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5)
    for gt, gj in zip(g_t, g_j):
        assert _rel(gt, gj) <= 1e-4
    # the tie: both copies of the target receive half
    np.testing.assert_allclose(g_t[1][0].numpy(), g_t[1][1].numpy())
    assert float(g_t[1][0].abs().sum()) > 0


# --- ARAP ---------------------------------------------------------------

def _trajectory(n, t, seed):
    rng = np.random.RandomState(seed)
    base = rng.uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    d = (rng.randn(t, n, 3) * 0.01).astype(np.float32)
    valid = np.ones(n, bool)
    valid[::11] = False
    return base, d, valid


def test_arap_shared_matches_jax():
    base, d, valid = _trajectory(60, 8, 0)
    (v_t, g_t), (v_j, g_j) = _both(
        lambda b, dd: tarap.arap_loss(b, dd, valid=_t(valid), radius=0.1),
        lambda b, dd: jarap.arap_loss(b, dd, valid=jnp.asarray(valid),
                                      radius=0.1), base, d)
    assert v_j > 0
    np.testing.assert_allclose(v_t, v_j, rtol=1e-4)
    assert _rel(g_t[1], g_j[1]) <= 1e-3
    assert g_t[0] is None or float(g_t[0].abs().max()) == 0  # base detached


def test_arap_sampled_matches_jax_with_the_same_sel():
    base, d, valid = _trajectory(300, 4, 1)
    key = jax.random.PRNGKey(3)
    # the node sample JAX's arap_loss draws from `key` (ops/arap.py:192-198)
    p = jnp.asarray(valid, jnp.float32)
    sel = np.asarray(jax.random.choice(key, 300, (128,), replace=True,
                                       p=p / jnp.sum(p))).astype(np.int64)
    (v_t, g_t), (v_j, g_j) = _both(
        lambda b, dd: tarap.arap_loss(b, dd, valid=_t(valid), radius=0.1,
                                      sample_num=128, sel=_t(sel)),
        lambda b, dd: jarap.arap_loss(b, dd, valid=jnp.asarray(valid),
                                      radius=0.1, sample_num=128, rng=key),
        base, d)
    assert v_j > 0
    np.testing.assert_allclose(v_t, v_j, rtol=1e-4)
    assert _rel(g_t[1], g_j[1]) <= 1e-3


def test_arap_sampled_needs_a_sample():
    base, d, _ = _trajectory(200, 3, 2)
    with pytest.raises(ValueError, match="generator or sel"):
        tarap.arap_loss(_t(base), _t(d), sample_num=64)
    out = tarap.arap_loss(_t(base), _t(d), sample_num=64,
                          generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out)


# --- schedules, learning rates, Adam --------------------------------------

@pytest.mark.parametrize("args", [(0.01, 0.0002, 0, 1.0, 500),
                                  (0.005, 0.0002, 100, 0.01, 30000),
                                  (2e-6, 2e-6, 0, 1.0, 500),
                                  (0.0, 0.0, 0, 1.0, 500)])
def test_expon_lr_matches_jax(args):
    ft, fj = tsched.expon_lr(*args), jsched.expon_lr(*args)
    for s in (-1, 0, 1, 50, 299, 300, 1500, 40000):
        np.testing.assert_allclose(float(ft(s)), float(fj(s)), rtol=1e-6)
    assert float(tsched.constant_lr(0.3)(7)) == float(jsched.constant_lr(0.3)(7))


@pytest.mark.parametrize("stage", ["s1", "s2"])
@pytest.mark.parametrize("step", [1, 300, 1500])
def test_group_lrs_match_jax(stage, step):
    lc_t, lc_j = tstep.LossConfig(), jstep.LossConfig()
    assert {f: getattr(lc_t, f) for f in lc_t.__dataclass_fields__} == \
        {f: getattr(lc_j, f) for f in lc_j.__dataclass_fields__}
    got = tstep.group_lrs(lc_t, step, stage)
    ref = jstep.group_lrs(lc_j, jnp.asarray(step), stage)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-6, err_msg=k)


def test_adam_update_matches_jax():
    rng = np.random.RandomState(8)
    shapes = {"xyz": (50, 3), "latent.codes": (4, 8), "timenet.rot_1.bias": (4,)}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    lrs = {"xyz": 0.01, "latent.codes": 0.005, "timenet.rot_1.bias": 2e-4}
    st_t = topt.init({k: _t(v) for k, v in p.items()})
    st_j = jopt.init({k: jnp.asarray(v) for k, v in p.items()})
    cur_t = {k: _t(v) for k, v in p.items()}
    cur_j = {k: jnp.asarray(v) for k, v in p.items()}
    for it in range(3):
        g = {k: (rng.randn(*s) * 10.0 ** (it - 1)).astype(np.float32)
             for k, s in shapes.items()}
        cur_t, st_t = topt.update(cur_t, {k: _t(v) for k, v in g.items()},
                                  st_t, lrs)
        cur_j, st_j = jopt.update(cur_j, {k: jnp.asarray(v) for k, v in g.items()},
                                  st_j, {k: jnp.float32(v) for k, v in lrs.items()})
        for k in shapes:
            for a, b in ((cur_t[k], cur_j[k]), (st_t.mu[k], st_j.mu[k]),
                         (st_t.nu[k], st_j.nu[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(st_t.step) == int(st_j.step) == 3


def test_leaf_groups_cover_every_leaf(small_scene):
    _, (_, tp, _), _ = small_scene
    groups = {k: topt.leaf_group(k) for k in topt.named_leaves(tp)}
    assert groups["timenet.rot_0.weight"] == "deform_rot"
    assert groups["timenet.trunk.3.bias"] == "deform"
    assert groups["latent.codes"] == "latent_code"
    assert groups["features_rest"] == "f_rest"
    assert set(groups.values()) <= set(tstep.group_lrs(tstep.LossConfig(), 1,
                                                       "s2"))
    with pytest.raises(KeyError):
        topt.leaf_group("nope")
