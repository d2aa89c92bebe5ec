"""One stage-1 training step of the port against the JAX package's
`make_train_step("s1")`, on the CPU.

Size: `init_model`'s blob at capacity 64 with 40 Gaussians (they are the
control points in s1), latent 8, 2 motions x 1 view x 2 frames rendered at
64x64 from a 128x128 uint8 ground truth (so both packages resize it),
capacity 64, at step 150 (the depth and normal gates, shared with s2, are
held open by `test_torch_train_step.py`). TimeNet's zero-initialised
heads get seeded weights. With one shared radius the covariance does not
depend on the rotations, so their gradient is rounding noise in both
packages (~1e-9 of the position gradient) and is held to that. The
ARAP gate is opened (`arap_start_iter_s1=100`) so its s1 branch carries
gradient; its times come from JAX's own key path.

Tolerances: loss 1e-5 relative; every leaf's gradient and the gradient of
the last render's `mean2d_tap` a relative L2 of 1e-3 (the tolerance of
`test_torch_train_step.py`); `denom` and `max_radii2d` exactly and
`xyz_grad_accum` (a norm of the tap gradient) at 1e-3, inside the
densification window; all three untouched outside it; and on a step whose
gradient is not finite the parameters stay and the statistics still
accumulate, as in the reference. GT resize against `jax.image.resize` at
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.models import gaussians as JG
from dimo_tpu.train import optim as jopt
from dimo_tpu.train import step as jstep
from dimo_tpu.utils import cameras as jcam

from dimo_tpu_torch.io.convert import params_from_numpy, port_leaves_from_numpy
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.train import optim as topt
from dimo_tpu_torch.train import step as tstep
from dimo_tpu_torch.utils import cameras as tcam

from test_torch_math import jax_to_numpy
from test_torch_train_step import _leaves_numpy
from torch_parity import one_torch_thread  # noqa: F401

W = H = 64
GT = 128
NM, NV, NF = 2, 1, 2
B = NM * NV * NF
N, CAP = 64, 64
IN_WINDOW, OUTSIDE = 150, 50         # window: step % 1000 >= 100, <= 1000


def _arap_times(rng_key):
    _, sub = jax.random.split(rng_key)
    return np.asarray(jax.random.uniform(jax.random.split(sub, B + NM)[B],
                                         (8,)))


@pytest.fixture(scope="module")
def run():
    cfg_j = JG.ModelConfig(sh_degree=0, latent_dim=8, num_latents=NM,
                           capacity=N, cpt_capacity=16)
    jp, ja = JG.init_model(cfg_j, seed=2, num_pts=40, num_cpts=12)
    d = jax_to_numpy(jp, ja)
    rng = np.random.RandomState(2)
    for k in ("pts_1_w", "rot_1_w"):
        d["timenet"][k] = (rng.randn(*d["timenet"][k].shape) * 0.02
                           ).astype(np.float32)
    # a shared radius large enough for a few-pixel footprint at 64^2
    d["r"] = np.full((1, 1), np.log(0.05), np.float32)
    jp = jp.replace(timenet={k: jnp.asarray(v) for k, v in d["timenet"].items()},
                    r=jnp.asarray(d["r"]))
    fov = float(np.deg2rad(49.1))
    cams = [jcam.Camera.from_c2w(jcam.orbit_camera(0, rng.uniform(0, 360), 2.0),
                                 fov, fov) for _ in range(B)]
    gt = rng.randint(0, 255, (B, GT, GT, 3), np.uint8)
    gm = rng.randint(0, 255, (B, GT, GT), np.uint8)
    times = rng.rand(B).astype(np.float32)
    lidx = np.repeat(np.arange(NM), NV * NF).astype(np.int32)
    mse_w = np.where(np.arange(B) % 2 == 0, 1.0, 0.5).astype(np.float32)

    lcfg_j = jstep.LossConfig(arap_start_iter_s1=100)
    jfn = jstep.make_train_step(cfg_j, lcfg_j, "s1", W, H, NM, NV, NF,
                                capacity=CAP)
    jbatch = {"camera": jcam.stack_cameras(cams), "times": jnp.asarray(times),
              "latent_idx": jnp.asarray(lidx), "mse_w": jnp.asarray(mse_w),
              "gt_image": jnp.asarray(gt), "gt_mask": jnp.asarray(gm)}
    key = jax.random.PRNGKey(7)

    @jax.jit
    def j_grads(params, rng_key, step):
        _, sub = jax.random.split(rng_key)
        taps = jnp.zeros((B, N, 2))
        (loss, _), (g, gtaps) = jax.value_and_grad(
            jfn.loss_fn, argnums=(0, 1), has_aux=True)(
                params, taps, ja, jbatch, sub, step)
        return loss, g, gtaps[-1]

    j_loss, j_g, j_gtap = j_grads(jp, key, jnp.asarray(IN_WINDOW))

    def j_state(params, step):
        return jstep.TrainState(
            params=jopt.strongify(params), aux=ja,
            opt=jopt.init(jopt.strongify(params)),
            step=jnp.asarray(step - 1, jnp.int32), rng=key)

    j_in, jm_in = jfn(j_state(jp, IN_WINDOW), jbatch)
    j_out, _ = jfn(j_state(jp, OUTSIDE), jbatch)
    jp_nan = jp.replace(features_dc=jnp.full_like(jp.features_dc, jnp.nan))
    j_nan, jm_nan = jfn(j_state(jp_nan, IN_WINDOW), jbatch)

    # --- the port, from the same weights
    cfg_t = TG.ModelConfig(sh_degree=0, latent_dim=8, num_latents=NM,
                           capacity=N, cpt_capacity=16)
    tbatch = {"camera": [tcam.Camera(*c) for c in cams], "times": times,
              "latent_idx": lidx, "mse_w": mse_w,
              "gt_image": torch.from_numpy(gt), "gt_mask": torch.from_numpy(gm)}
    tfn = tstep.make_train_step(cfg_t, tstep.LossConfig(arap_start_iter_s1=100),
                                "s1", W, H, NM, NV, NF, capacity=CAP)
    times_arap = _arap_times(key)

    def t_state(dd, step):
        tp, ta = params_from_numpy(dd, device="cpu")
        return tstep.init_state(tp, ta, step=step - 1)

    s = t_state(d, IN_WINDOW)
    tap = torch.zeros((N, 2), requires_grad=True)
    t_loss, (t_met, _) = tfn.loss_fn(s.params, s.aux, tbatch, IN_WINDOW,
                                     arap_times=times_arap, tap=tap)
    t_loss.backward()
    t_g = {k: (v.grad.clone() if v.grad is not None else torch.zeros_like(v))
           for k, v in topt.named_leaves(s.params).items()}
    t_in, tm_in = tfn(t_state(d, IN_WINDOW), tbatch, arap_times=times_arap)
    t_out, _ = tfn(t_state(d, OUTSIDE), tbatch, arap_times=times_arap)
    d_nan = dict(d, features_dc=np.full_like(d["features_dc"], np.nan))
    t_nan, tm_nan = tfn(t_state(d_nan, IN_WINDOW), tbatch,
                        arap_times=times_arap)
    aux_np = lambda a: {f: np.asarray(getattr(a, f)) if not isinstance(  # noqa: E731
        getattr(a, f), torch.Tensor) else getattr(a, f).numpy()
        for f in ("xyz_grad_accum", "denom", "max_radii2d")}
    return dict(
        j_loss=float(j_loss), t_loss=float(t_loss.detach()),
        t_arap=float(t_met["arap"]),
        j_g=port_leaves_from_numpy(_leaves_numpy(j_g), "cpu"), t_g=t_g,
        j_gtap=np.asarray(j_gtap), t_gtap=tap.grad.numpy(),
        j_in=aux_np(j_in.aux), t_in=aux_np(t_in.aux),
        j_out=aux_np(j_out.aux), t_out=aux_np(t_out.aux),
        j_nan=aux_np(j_nan.aux), t_nan=aux_np(t_nan.aux),
        nonfinite=(int(jm_in["nonfinite_grad"]), int(tm_in["nonfinite_grad"]),
                   int(jm_nan["nonfinite_grad"]), int(tm_nan["nonfinite_grad"])),
        t_nan_state=t_nan, xyz0=d["xyz"], t_in_state=t_in)


def test_s1_loss_matches_jax(run):
    np.testing.assert_allclose(run["t_loss"], run["j_loss"], rtol=1e-5)
    assert run["t_arap"] > 0            # the s1 ARAP branch is live


LEAF_GROUPS = list(topt.PARAM_FIELDS) + ["latent", "timenet"]


@pytest.mark.parametrize("group", LEAF_GROUPS)
def test_s1_leaf_grads_match_jax(run, group):
    names = [k for k in run["t_g"] if k.split(".")[0] == group]
    assert names
    noise = 1e-7 * float(torch.linalg.norm(run["j_g"]["xyz"]))
    for k in names:
        got, ref = run["t_g"][k], run["j_g"][k]
        norm = float(torch.linalg.norm(ref))
        if norm == 0:         # unused in s1 (scaling, c_xyz, c_radius) or empty
            assert not bool(got.any()), k
            continue
        if norm < noise:      # rotation: analytically zero, see above
            assert float(torch.linalg.norm(got)) < noise, k
            continue
        rel = float(torch.linalg.norm(got - ref)) / norm
        assert rel <= 1e-3, (k, rel)
    if group == "r":
        assert float(run["j_g"]["r"].abs().sum()) > 0


def test_tap_gradient_matches_jax(run):
    got, ref = run["t_gtap"], run["j_gtap"]
    assert np.linalg.norm(ref) > 0
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-3


@pytest.mark.parametrize("which", ["in", "out", "nan"])
def test_densification_stats_match_jax(run, which):
    j, t = run[f"j_{which}"], run[f"t_{which}"]
    np.testing.assert_array_equal(t["denom"], j["denom"])
    np.testing.assert_array_equal(t["max_radii2d"], j["max_radii2d"])
    if which == "out":
        for f in t:
            assert float(np.abs(t[f]).sum()) == 0.0, f
        return
    assert float(t["denom"].sum()) > 0 and float(t["max_radii2d"].sum()) > 0
    if which == "in":
        ref = j["xyz_grad_accum"]
        rel = np.linalg.norm(t["xyz_grad_accum"] - ref) / np.linalg.norm(ref)
        assert rel <= 1e-3, rel
        # the norm of the tap gradient over the visible gaussians
        vis = t["denom"] > 0
        np.testing.assert_allclose(
            t["xyz_grad_accum"], np.where(vis, np.linalg.norm(
                run["t_gtap"], axis=-1), 0.0), rtol=1e-5, atol=1e-12)


def test_nonfinite_step_is_skipped_but_stats_accumulate(run):
    assert run["nonfinite"] == (0, 0, 1, 1)
    state = run["t_nan_state"]
    np.testing.assert_array_equal(state.params.xyz.detach().numpy(), run["xyz0"])
    assert int(state.opt.step) == 0 and state.step == IN_WINDOW
    assert not np.array_equal(
        run["t_in_state"].params.xyz.detach().numpy(), run["xyz0"])


@pytest.mark.parametrize("dst", [32, 16, 48])
def test_gt_resize_matches_jax_image_resize(dst):
    """Half-pixel linear, antialiased where it shrinks (64 -> 32, 16, 48)."""
    x = np.random.RandomState(dst).rand(3, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, dst, dst, 3),
                                      "linear"))
    got = tstep.resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), dst,
                              dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    # a plain bilinear sample (no antialias) is NOT what the reference does
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - ref).max() > 1e-2


def test_stage_argument_is_checked():
    cfg = TG.ModelConfig(capacity=8, cpt_capacity=8)
    tstep.make_train_step(cfg, tstep.LossConfig(), "s1", 32, 32, 1, 1, 1)
    with pytest.raises(ValueError, match="stage"):
        tstep.make_train_step(cfg, tstep.LossConfig(), "s3", 32, 32, 1, 1, 1)
