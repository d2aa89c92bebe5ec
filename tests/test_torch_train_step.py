"""One stage-2 training step of the port against the JAX package's
`make_train_step`, on the CPU.

Size: the flagship scene cut to 512 Gaussians, 32 control points and a
latent of 8; 2 motions x 1 view x 2 frames at 128x64, capacity 128, at
step 300 (the depth/normal gates (> 200) and the ARAP gate (< 2000) are
open), with chamfer guidance. TimeNet's zero-initialised heads get
seeded random weights in both packages, or every trunk gradient would be
zero. The JAX side runs its Pallas kernels in interpret mode and its
plain one-hot LBS gather (the bf16 split of its Pallas gather moves
sub-pixel Gaussians by ~1e-4 of a pixel; `test_torch_gather_bwd.py`
holds that split on its own). ARAP's times come from JAX's own key path
(`state.rng` -> sub -> split(sub, B + n_motions)[B] -> uniform).

Tolerances: loss and every metric rtol 1e-4; every leaf's gradient a
relative L2 of 1e-3 (measured <= 7e-4: float32 sums in another order
through 4 renders, SSIM and ARAP). After Adam: the first step moves an
element by about +-lr whatever its gradient's size, so elements whose
reference gradient is below 1e-3 of the leaf's largest may move either
way (|diff| <= 2 lr); the others agree to 1e-2 lr. The second step's
direction m/sqrt(v) mixes the carried moments with the new gradient and
is ill-conditioned where the two nearly cancel (one element of 350k moved
by 0.17 lr), so it is held per leaf: over the elements whose reference
gradient exceeds 1e-3 of the leaf's largest, the relative L2 of the
port's update against the reference's is at most 1e-2; the others again
within 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_scene
from dimo_tpu.models import deform as jdef
from dimo_tpu.train import optim as jopt
from dimo_tpu.train import step as jstep
from dimo_tpu.utils import cameras as jcam

from dimo_tpu_torch.io.convert import (params_from_numpy,
                                       port_leaves_from_numpy,
                                       train_state_from_numpy)
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.train import optim as topt
from dimo_tpu_torch.train import step as tstep
from dimo_tpu_torch.utils import cameras as tcam

from test_torch_math import jax_to_numpy
from test_torch_render import _exact_jax_gather
from torch_parity import one_torch_thread  # noqa: F401

W, H, NM, NV, NF = 128, 64, 2, 1, 2
B = NM * NV * NF
STEP = 300
CAP = 128


def _leaves_numpy(tree) -> dict:
    """A dimo_tpu GaussianParams-shaped pytree as numpy, JAX layout."""
    d = {f: np.asarray(getattr(tree, f)) for f in topt.PARAM_FIELDS}
    d["latent"] = {k: np.asarray(v) for k, v in tree.latent.items()}
    d["timenet"] = {k: np.asarray(v) for k, v in tree.timenet.items()}
    return d


def _arap_times(rng_key):
    _, sub = jax.random.split(rng_key)
    return np.asarray(jax.random.uniform(jax.random.split(sub, B + NM)[B],
                                         (8,)))


def make_inputs():
    """The scene (JAX objects and its numpy leaves `d`, TimeNet heads
    seeded) and one batch in both packages' forms."""
    cfg_j, jp, ja, _ = _flagship_scene(n_gauss=512, n_cpts=32, latent_dim=8,
                                       seed=3)
    d = jax_to_numpy(jp, ja)
    rng = np.random.RandomState(3)
    for k in ("pts_1_w", "rot_1_w"):
        d["timenet"][k] = (rng.randn(*d["timenet"][k].shape) * 0.02
                           ).astype(np.float32)
    jp = jp.replace(timenet={k: jnp.asarray(v) for k, v in d["timenet"].items()})
    fov = float(np.deg2rad(33.9))
    cams = [jcam.Camera.from_c2w(jcam.orbit_camera(0, rng.uniform(0, 360), 2.0),
                                 fov, fov) for _ in range(B)]
    gt = rng.randint(0, 255, (B, H, W, 3), np.uint8)
    gm = rng.randint(0, 255, (B, H, W), np.uint8)
    times = rng.rand(B).astype(np.float32)
    lidx = np.repeat(np.arange(NM), NV * NF).astype(np.int32)
    guid = (d["c_xyz"][None] + rng.randn(B, 32, 3) * 0.01).astype(np.float32)
    mse_w = np.where(np.arange(B) % 2 == 0, 1.0, 0.5).astype(np.float32)
    jbatch = {"camera": jcam.stack_cameras(cams), "times": jnp.asarray(times),
              "latent_idx": jnp.asarray(lidx), "mse_w": jnp.asarray(mse_w),
              "gt_image": jnp.asarray(gt), "gt_mask": jnp.asarray(gm),
              "guidance": jnp.asarray(guid)}
    tbatch = {"camera": [tcam.Camera(*c) for c in cams], "times": times,
              "latent_idx": lidx, "mse_w": mse_w,
              "gt_image": torch.from_numpy(gt), "gt_mask": torch.from_numpy(gm),
              "guidance": torch.from_numpy(guid)}
    cfg_t = TG.ModelConfig(sh_degree=0, latent_dim=8, num_latents=4,
                           capacity=512, cpt_capacity=32)
    return cfg_j, jp, ja, d, jbatch, cfg_t, tbatch


@pytest.fixture(scope="module")
def run():
    mp = pytest.MonkeyPatch()
    mp.setattr(jdef, "gather_small_cols", _exact_jax_gather)
    cfg_j, jp, ja, d, jbatch, cfg_t, tbatch = make_inputs()

    # --- JAX: make_train_step's loss_fn and gradients at STEP and STEP + 1,
    # each followed by the step's update (group_lrs -> build_lr_tree ->
    # optim.update: what its train_step does on a finite step), jitted
    # once for both steps
    lcfg = jstep.LossConfig()
    jfn = jstep.make_train_step(cfg_j, lcfg, "s2", W, H, NM, NV, NF,
                                capacity=CAP, use_guidance=True)
    taps = jnp.zeros((B, 512, 2))

    @jax.jit
    def j_step(params, opt, rng, step):
        rng, sub = jax.random.split(rng)
        (loss, (metrics, _)), g = jax.value_and_grad(jfn.loss_fn, has_aux=True)(
            params, taps, ja, jbatch, sub, step)
        lr_tree = jopt.build_lr_tree(params, jstep.group_lrs(lcfg, step, "s2"))
        new, new_opt = jopt.update(params, g, opt, lr_tree)
        return loss, metrics, g, new, new_opt, rng

    rng0 = jax.random.PRNGKey(7)
    j_loss1, j_met1, j_g1, j1, j1_opt, rng1 = j_step(
        jp, jopt.init(jp), rng0, jnp.asarray(STEP))
    _, _, j_g2, j2, _, _ = j_step(j1, j1_opt, rng1, jnp.asarray(STEP + 1))
    j_met1 = {k: float(v) for k, v in j_met1.items()}
    mp.undo()

    # --- the port, from the same weights
    tfn = tstep.make_train_step(cfg_t, tstep.LossConfig(), "s2", W, H, NM, NV,
                                NF, capacity=CAP, use_guidance=True)
    tp, ta = params_from_numpy(d, device="cpu")
    t0 = tstep.init_state(tp, ta, step=STEP - 1)
    leaves = topt.named_leaves(t0.params)
    t_loss1, (t_met1, _) = tfn.loss_fn(t0.params, t0.aux, tbatch, STEP,
                                       arap_times=_arap_times(rng0))
    t_loss1.backward()
    t_g1 = {k: (v.grad.clone() if v.grad is not None else torch.zeros_like(v))
            for k, v in leaves.items()}
    t1, t_m1 = tfn(t0, tbatch, arap_times=_arap_times(rng0))
    # the second step starts from JAX's state after step 1
    opt1 = {"mu": _leaves_numpy(j1_opt.mu), "nu": _leaves_numpy(j1_opt.nu),
            "step": int(j1_opt.step)}
    t1b = train_state_from_numpy(jax_to_numpy(j1, ja), opt1, STEP,
                                 device="cpu")
    t2, t_m2 = tfn(t1b, tbatch, arap_times=_arap_times(rng1))
    return dict(
        j_loss1=float(j_loss1), j_met1=j_met1, t_loss1=float(t_loss1.detach()),
        t_met1={k: float(v) for k, v in t_met1.items()},
        j_g1=port_leaves_from_numpy(_leaves_numpy(j_g1), "cpu"), t_g1=t_g1,
        j_g2=port_leaves_from_numpy(_leaves_numpy(j_g2), "cpu"),
        j1=port_leaves_from_numpy(_leaves_numpy(j1), "cpu"),
        j2=port_leaves_from_numpy(_leaves_numpy(j2), "cpu"),
        t1={k: v.detach() for k, v in topt.named_leaves(t1.params).items()},
        t2={k: v.detach() for k, v in topt.named_leaves(t2.params).items()},
        t_m=(t_m1, t_m2), t_state=(t1, t2))


def test_loss_and_metrics_match_jax(run):
    assert run["j_met1"].keys() == run["t_met1"].keys()
    np.testing.assert_allclose(run["t_loss1"], run["j_loss1"], rtol=1e-4)
    for k, v in run["j_met1"].items():
        np.testing.assert_allclose(run["t_met1"][k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    # every term is live at step 300
    for k in ("arap", "ga", "smooth", "bilateral", "ssim_loss", "mask_loss"):
        assert run["j_met1"][k] > 0, k


LEAF_GROUPS = list(topt.PARAM_FIELDS) + ["latent", "timenet"]


@pytest.mark.parametrize("group", LEAF_GROUPS)
def test_leaf_grads_match_jax(run, group):
    names = [k for k in run["t_g1"] if k.split(".")[0] == group]
    assert names
    for k in names:
        got, ref = run["t_g1"][k], run["j_g1"][k]
        norm = float(torch.linalg.norm(ref))
        if norm == 0:             # unused in s2 (r) or empty (deg-0 SH rest)
            assert not bool(got.any()), k
            continue
        rel = float(torch.linalg.norm(got - ref)) / norm
        assert rel <= 1e-3, (k, rel)


def _assert_adam_close(got, ref, g_ref, lr, what):
    """|got - ref| <= 1e-2 lr where |g_ref| > 1e-3 max|g_ref|, else 2 lr
    (plus a float32 ulp of the value)."""
    ulp = 2e-7 * ref.abs()
    big = g_ref.abs() > 1e-3 * float(g_ref.abs().amax()) if g_ref.numel() \
        else torch.zeros_like(ref, dtype=torch.bool)
    tol = torch.where(big, torch.full_like(ref, 1e-2 * lr),
                      torch.full_like(ref, 2 * lr)) + ulp
    bad = (got - ref).abs() > tol
    assert not bool(bad.any()), (what, int(bad.sum()),
                                 float((got - ref).abs().max()), lr)


def _assert_later_step_close(upd_t, upd_j, value, g_ref, lr, what):
    """An Adam update after the first, whose moments carry the earlier
    steps' gradients: |upd_t - upd_j| <= 2 lr (plus a float32 ulp of
    `value`) everywhere, and within 1e-2 in relative L2 norm over the
    elements where |g_ref| > 1e-3 max|g_ref|."""
    assert bool(((upd_t - upd_j).abs() <= 2 * lr + 2e-7 * value.abs()
                 ).all()), what
    big = g_ref.abs() > 1e-3 * float(g_ref.abs().amax()) \
        if g_ref.numel() else torch.zeros_like(upd_j, dtype=torch.bool)
    norm = float(torch.linalg.norm(upd_j[big]))
    if lr == 0 or norm == 0:
        return
    rel = float(torch.linalg.norm((upd_t - upd_j)[big])) / norm
    assert rel <= 1e-2, (what, rel)


@pytest.mark.parametrize("which", [1, 2])
def test_params_after_adam_match_jax(run, which):
    got, ref = run[f"t{which}"], run[f"j{which}"]
    g_ref = run[f"j_g{which}"]
    lrs = tstep.group_lrs(tstep.LossConfig(), STEP - 1 + which, "s2")
    for k in got:
        lr = lrs[topt.leaf_group(k)]
        if which == 1:
            _assert_adam_close(got[k], ref[k], g_ref[k], lr, k)
            continue
        _assert_later_step_close(got[k] - run["j1"][k], ref[k] - run["j1"][k],
                                 ref[k], g_ref[k], lr, k)
    t_m = run["t_m"][which - 1]
    assert int(t_m["nonfinite_grad"]) == 0
    gnorm = float(torch.sqrt(sum(torch.sum(g * g) for g in g_ref.values())))
    np.testing.assert_allclose(float(t_m["grad_norm"]), gnorm, rtol=1e-3)
    state = run["t_state"][which - 1]
    assert state.step == STEP - 1 + which
    assert int(state.opt.step) == which


def test_guard_skips_a_nonfinite_step(run):
    """A NaN gradient leaves parameters, moments and the Adam count alone."""
    state = run["t_state"][1]
    cfg_t = TG.ModelConfig(sh_degree=0, latent_dim=8, num_latents=4,
                           capacity=512, cpt_capacity=32)
    tfn = tstep.make_train_step(cfg_t, tstep.LossConfig(use_arap=False),
                                "s2", 32 * 4, 32, 1, 1, 1, capacity=32)
    rng = np.random.RandomState(0)
    fov = float(np.deg2rad(33.9))
    batch = {"camera": [tcam.Camera.from_c2w(tcam.orbit_camera(0, 20, 2.0),
                                             fov, fov)],
             "times": np.zeros(1, np.float32), "latent_idx": np.zeros(1, int),
             "mse_w": np.ones(1, np.float32),
             "gt_image": torch.from_numpy(rng.randint(0, 255, (1, 32, 128, 3),
                                                      np.uint8)),
             "gt_mask": torch.from_numpy(rng.randint(0, 255, (1, 32, 128),
                                                     np.uint8)),
             "guidance": torch.zeros(1, 32, 3)}
    with torch.no_grad():
        state.params.features_dc[:] = float("nan")
    before = {k: v.detach().clone()
              for k, v in topt.named_leaves(state.params).items()}
    mu0 = {k: v.clone() for k, v in state.opt.mu.items()}
    count0 = int(state.opt.step)
    state, metrics = tfn(state, batch)
    assert int(metrics["nonfinite_grad"]) == 1
    for k, v in topt.named_leaves(state.params).items():
        assert torch.equal(v, before[k]) or (k == "features_dc"), k
    assert all(torch.equal(state.opt.mu[k], mu0[k]) for k in mu0)
    assert int(state.opt.step) == count0
    # a GT of another size than the render is resized, not refused
    half = dict(batch, gt_image=batch["gt_image"][:, :16, :64],
                gt_mask=batch["gt_mask"][:, :16, :64])
    loss, _ = tfn.loss_fn(state.params, state.aux, half, 1)
    assert loss.shape == ()


def test_vae_kl_and_l1_guidance_terms():
    """The KL term of the VAE variant and the L1 (non-chamfer) guidance,
    against their closed forms: TimeNet's zero heads leave the control
    points where they are, so guidance offset by 0.01 gives 0.01 per
    render."""
    from dimo_tpu_torch.scenes import flagship_scene
    cfg, params, aux, cam = flagship_scene(256, 32, 8, seed=1, device="cpu")
    cfg = TG.ModelConfig(sh_degree=0, latent_dim=8, num_latents=4, vae=True,
                         capacity=256, cpt_capacity=32)
    rng = np.random.RandomState(2)
    mu = rng.randn(4, 8).astype(np.float32)
    log_var = (rng.randn(4, 8) * 0.3).astype(np.float32)
    params = params.replace(latent={"mu": torch.from_numpy(mu),
                                    "log_var": torch.from_numpy(log_var)})
    state = tstep.init_state(params, aux, step=10)
    lcfg = tstep.LossConfig(vae=True, ga_chamfer=False, use_arap=False)
    fn = tstep.make_train_step(cfg, lcfg, "s2", 128, 64, 2, 1, 1,
                               capacity=64, use_guidance=True)
    lidx = np.array([1, 3], np.int32)
    batch = {"camera": [tcam.Camera(*cam)] * 2,
             "times": np.array([0.2, 0.7], np.float32), "latent_idx": lidx,
             "mse_w": np.ones(2, np.float32),
             "gt_image": torch.zeros(2, 64, 128, 3, dtype=torch.uint8),
             "gt_mask": torch.zeros(2, 64, 128, dtype=torch.uint8),
             "guidance": (params.c_xyz.detach() + 0.01)[None].repeat(2, 1, 1)}
    loss, (metrics, _) = fn.loss_fn(state.params, state.aux, batch, 11,
                                    generator=state.rng)
    kl = np.sum(-0.5 * np.sum(1 + log_var[lidx] - mu[lidx] ** 2
                              - np.exp(log_var[lidx]), axis=-1))
    np.testing.assert_allclose(float(metrics["kl"]), kl, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ga"]), 2 * 0.01, rtol=1e-4)
    loss.backward()
    assert float(params.latent["log_var"].grad[lidx].abs().sum()) > 0
    assert float(params.latent["log_var"].grad[[0, 2]].abs().sum()) == 0
