"""The stage-2 step with LPIPS on, and test-time fine-tuning
(`trainable_groups`), in the port against the JAX package's
`make_train_step`, on the CPU.

Size and inputs: `test_torch_train_step.py`'s (512 Gaussians, 2 motions x
1 view x 2 frames at 128x64, capacity 128, step 300, chamfer guidance),
with `random_init_lpips(0)` in both packages (bit-equal weights). The
JAX side runs its Pallas kernels in interpret mode and its plain one-hot
LBS gather, as that file does.

One JAX step serves both checks: a fine-tuning step turns ARAP off, so
the JAX loss with `trainable_groups` is the loss of an s2 step with
`use_arap=False`, and the port computes it both ways (ARAP itself is
held by `test_torch_train_step.py`).

Tolerances: that file's. Loss and every metric rtol 1e-4; every leaf's
gradient a relative L2 of 1e-3. The fine-tuning step: every leaf outside
the trainable groups bit-equal to its value before the step (learning
rate 0) in both packages, ARAP 0 in both, and the trained leaves' update
within `_assert_adam_close`'s first-step bound of the JAX update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.models import deform as jdef
from dimo_tpu.models import lpips as jlpips
from dimo_tpu.train import optim as jopt
from dimo_tpu.train import step as jstep

from dimo_tpu_torch.io.convert import params_from_numpy, port_leaves_from_numpy
from dimo_tpu_torch.models import lpips as tlpips
from dimo_tpu_torch.train import optim as topt
from dimo_tpu_torch.train import step as tstep

from test_torch_render import _exact_jax_gather
from test_torch_train_step import (B, CAP, H, NF, NM, NV, STEP, W,
                                   _arap_times, _assert_adam_close,
                                   _leaves_numpy, make_inputs)
from torch_parity import one_torch_thread  # noqa: F401

FINETUNE = frozenset({"latent_code"})


@pytest.fixture(scope="module")
def run():
    """Loss, metrics and gradients of one s2 step with LPIPS on, in both
    packages: the JAX fine-tuning step of FINETUNE, against the port's
    s2 step without ARAP (`groups` None) and its fine-tuning step, the
    latter also through the update."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jdef, "gather_small_cols", _exact_jax_gather)
    cfg_j, jp, ja, d, jbatch, cfg_t, tbatch = make_inputs()
    lcfg = jstep.LossConfig()
    rng0 = jax.random.PRNGKey(7)
    _, sub = jax.random.split(rng0)
    taps = jnp.zeros((B, 512, 2))
    jfn = jstep.make_train_step(cfg_j, lcfg, "s2", W, H, NM, NV, NF,
                                capacity=CAP,
                                lpips_fn=jlpips.random_init_lpips(0),
                                use_guidance=True, trainable_groups=FINETUNE)
    (loss, (metrics, _)), g = jax.jit(jax.value_and_grad(
        jfn.loss_fn, has_aux=True))(jp, taps, ja, jbatch, sub,
                                    jnp.asarray(STEP))
    new = jopt.update(jp, g, jopt.init(jp), jopt.build_lr_tree(
        jp, jstep.group_lrs(lcfg, STEP, "s2", FINETUNE)))[0]
    mp.undo()
    out = {}
    for groups in (None, FINETUNE):
        tfn = tstep.make_train_step(cfg_t,
                                    tstep.LossConfig(use_arap=bool(groups)),
                                    "s2", W, H, NM, NV, NF, capacity=CAP,
                                    lpips_fn=tlpips.random_init_lpips(
                                        0, "cpu"),
                                    use_guidance=True,
                                    trainable_groups=groups)
        tp, ta = params_from_numpy(d, device="cpu")
        t0 = tstep.init_state(tp, ta, step=STEP - 1)
        leaves = topt.named_leaves(t0.params)
        before = {k: v.detach().clone() for k, v in leaves.items()}
        t_loss, (t_met, _) = tfn.loss_fn(t0.params, t0.aux, tbatch, STEP,
                                         arap_times=_arap_times(rng0))
        t_loss.backward()
        t_g = {k: (v.grad.clone() if v.grad is not None
                   else torch.zeros_like(v)) for k, v in leaves.items()}
        t1, t_m1 = tfn(t0, tbatch, arap_times=_arap_times(rng0))
        out[groups] = dict(
            j_loss=float(loss), j_met={k: float(v) for k, v in metrics.items()},
            t_loss=float(t_loss.detach()),
            t_met={k: float(v) for k, v in t_met.items()},
            j_g=port_leaves_from_numpy(_leaves_numpy(g), "cpu"), t_g=t_g,
            j_new=port_leaves_from_numpy(_leaves_numpy(new), "cpu"),
            j_old=port_leaves_from_numpy(_leaves_numpy(jp), "cpu"),
            before=before, t_m1=t_m1,
            t_new={k: v.detach() for k, v in
                   topt.named_leaves(t1.params).items()})
    return out


@pytest.mark.parametrize("groups", [None, FINETUNE], ids=["s2", "finetune"])
def test_loss_and_metrics_match_jax(run, groups):
    r = run[groups]
    assert r["j_met"].keys() == r["t_met"].keys()
    np.testing.assert_allclose(r["t_loss"], r["j_loss"], rtol=1e-4)
    for k, v in r["j_met"].items():
        np.testing.assert_allclose(r["t_met"][k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    assert r["j_met"]["lpips"] > 0
    assert r["t_met"]["arap"] == r["j_met"]["arap"] == 0.0


@pytest.mark.parametrize("groups", [None, FINETUNE], ids=["s2", "finetune"])
def test_leaf_grads_match_jax(run, groups):
    r = run[groups]
    for k, ref in r["j_g"].items():
        got = r["t_g"][k]
        norm = float(torch.linalg.norm(ref))
        if norm == 0:
            assert not bool(got.any()), k
            continue
        rel = float(torch.linalg.norm(got - ref)) / norm
        assert rel <= 1e-3, (k, rel)


def test_fine_tuning_step_trains_only_its_groups(run):
    r = run[FINETUNE]
    assert int(r["t_m1"]["nonfinite_grad"]) == 0
    assert float(r["t_m1"]["arap"]) == 0.0
    lrs = tstep.group_lrs(tstep.LossConfig(), STEP, "s2", FINETUNE)
    for k, new in r["t_new"].items():
        group = topt.leaf_group(k)
        if group in FINETUNE:
            assert not torch.equal(new, r["before"][k]), k
            _assert_adam_close(new, r["j_new"][k], r["j_g"][k], lrs[group], k)
        else:
            assert lrs[group] == 0.0, k
            assert torch.equal(new, r["before"][k]), k
            assert torch.equal(r["j_new"][k], r["j_old"][k]), k


@pytest.mark.parametrize("stage", ["s1", "s2"])
@pytest.mark.parametrize("groups", [
    frozenset({"latent_code"}),
    frozenset({"latent_code_mu", "latent_code_log_var", "c_xyz", "deform"})])
@pytest.mark.parametrize("step", [1, 300, 1200])
def test_group_lrs_with_trainable_groups_match_jax(stage, groups, step):
    lcfg = jstep.LossConfig()
    ref = jstep.group_lrs(lcfg, jnp.asarray(step), stage, groups)
    got = tstep.group_lrs(tstep.LossConfig(), step, stage, groups)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert np.float32(got[k]) == np.float32(v), (k, got[k], float(v))
        if k not in groups:
            assert got[k] == 0.0, k
