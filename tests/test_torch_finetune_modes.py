"""The port's fine-tuning and language test modes against the JAX
package's, on the CPU: `finetune_latent_to_motion` (with LPIPS on),
`_finetune_cpt_only` and `run_test_unaligned_motion`, `run_test_motion`,
`load_mlp_projector` and `run_test_language`.

The checkpoint is `test_torch_test_modes.py`'s (the port's trainer at
`tiny_synthetic_opt`'s size, TimeNet's output layers seeded); the unseen
motion is one synthetic motion of 3 views x 5 frames at 64x64 (seed 7),
the same numpy arrays in both packages. LPIPS is `random_init_lpips(0)`
in both (bit-equal weights, `test_torch_lpips.py`). Both trainers start
from `random.Random(seed)`, so they sample the same (view, frame) tuples
if they consume it in the same order. A fresh latent is drawn from
`jax.random.normal` in the reference and from a `torch.Generator` in the
port, other numbers of the same law; here both are set to one numpy
array (the test replaces `jax.random.normal` for that shape, and the
port's `_fresh_codes`).

Tolerances (`test_torch_train_lpips.py`'s and `test_torch_train_step.py`'s):
every step's loss and metrics rtol 1e-4, and its gradient norm and sup
1e-3 (the gradients' relative L2 tolerance there; measured 1.01e-4 for
the control-point phase's norm). Every step's update of every fitted
leaf (the latent codes and TimeNet's leaves, the frozen ones included)
is held to the reference's update from the same step, with the reference
gradient read back from its Adam first moment, g_t = (mu_t - beta1
mu_(t-1)) / (1 - beta1). A fit's first step: `_assert_adam_close`, 1e-2
lr where the reference gradient is above 1e-3 of its largest element, 2
lr elsewhere (Adam moves an element by about its learning rate whatever
its gradient's size), plus a float32 ulp. A later step, whose moments
carry the earlier gradients (`test_torch_train_step.py`'s second-step
bound, `_assert_later_step_close`): 2 lr everywhere, and 1e-2 in
relative L2 over the elements above 1e-3 of the largest gradient
(measured 1.14e-3 at the control-point phase's second step, where the
gradient's own relative L2 difference is 7.9e-4). A wrong-signed
gradient fails both.
Every leaf outside the trained groups is bit-equal to the checkpoint.
Frames rendered after a fit: `test_torch_test_modes.py`'s (1 LSB + 1e-4
except at alpha-cut flips). The projector's weights: equal; its output
within the float32 rounding of a 768-term dot product, 768 u sum|e_i w_ij|
(u = 2^-24; the two BLAS libraries sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu import test_modes as jtm
from dimo_tpu.models import lpips as jlpips
from dimo_tpu.models import text as jtext
from dimo_tpu.train import optim as jopt
from dimo_tpu.train import step as jstep

from dimo_tpu_torch import test_modes as ttm
from dimo_tpu_torch.io.convert import timenet_to_numpy
from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.models import lpips as tlpips
from dimo_tpu_torch.models import text as ttext
from dimo_tpu_torch.train import optim as topt
from dimo_tpu_torch.train import step as tstep

from test_torch_train_step import _assert_adam_close, _assert_later_step_close
from test_torch_test_modes import (assert_frames_close, ckpt,  # noqa: F401
                                   trainers, written)
from torch_parity import one_torch_thread  # noqa: F401

ITERS = 2
METRIC_RTOL = 1e-4
GRAD_RTOL = 1e-3               # metrics computed from the gradients
U32 = 2.0 ** -24


@pytest.fixture(scope="module")
def motion():
    images, masks, _ = make_synthetic_videos(
        num_motions=1, num_views=3, num_frames=5, ref_size=64, n_gauss=40,
        seed=7, device="cpu")
    return images[0], masks[0]


def _scalars(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}


def _record_batches(mp, calls):
    """Wrap both packages' `_device_batch_sampler` to record each
    iteration's (views, frames)."""
    for which, mod in (("jax", jtm), ("torch", ttm)):
        real = mod._device_batch_sampler

        def sampler(tr, images, masks, n_guid, real=real, which=which):
            assemble = real(tr, images, masks, n_guid)

            def wrapped(views, frames):
                calls[which].append((tuple(views), tuple(frames)))
                return assemble(views, frames)
            return wrapped
        mp.setattr(mod, "_device_batch_sampler", sampler)


def _fix_fresh_codes(mp, codes: np.ndarray):
    """Both packages' fresh latent draw returns `codes`."""
    real = jax.random.normal

    def normal(key, shape=(), *a, **k):
        if tuple(shape) == codes.shape:
            return jnp.asarray(codes)
        return real(key, shape, *a, **k)
    mp.setattr(jax.random, "normal", normal)
    mp.setattr(ttm, "_fresh_codes",
               lambda seed, dim, device: torch.from_numpy(codes.copy()))


def _fit_leaves(which: str, params) -> dict:
    """{port leaf name: float64 array} of the leaves a fit may train: the
    latent codes and TimeNet's (JAX names, `timenet_to_numpy`'s)."""
    if which == "torch":
        codes = params.latent["codes"].detach().numpy()
        net = timenet_to_numpy(params.timenet)
    else:
        codes = np.asarray(params.latent["codes"])
        net = {k: np.asarray(v) for k, v in params.timenet.items()}
    out = {"latent.codes": codes}
    out.update({f"timenet.{k}": v for k, v in net.items()})
    return {k: np.array(v, np.float64) for k, v in out.items()}


def _record_steps(mp, steps):
    """Wrap both packages' `make_train_step` to record, for each step, its
    stage, stage-local step, trainable groups and loss config, and the
    fitted leaves before and after it; for the reference also its
    gradient, recovered from the Adam first moment."""
    for which, mod in (("jax", jstep), ("torch", tstep)):
        real = mod.make_train_step

        def make(cfg, lcfg, stage, *a, real=real, which=which, **k):
            fn = real(cfg, lcfg, stage, *a, **k)

            def step(state, batch):
                rec = dict(stage=stage, step=int(state.step) + 1, lcfg=lcfg,
                           groups=k.get("trainable_groups"),
                           before=_fit_leaves(which, state.params))
                mu0 = (_fit_leaves(which, state.opt.mu) if which == "jax"
                       else None)
                state, metrics = fn(state, batch)
                rec["after"] = _fit_leaves(which, state.params)
                if which == "jax":
                    mu1 = _fit_leaves(which, state.opt.mu)
                    rec["grad"] = {n: (mu1[n] - jopt.BETA1 * mu0[n])
                                   / (1 - jopt.BETA1) for n in mu1}
                steps[which].append(rec)
                return state, metrics
            return step
        mp.setattr(mod, "make_train_step", make)


def _assert_steps_close(t_steps: list, j_steps: list):
    """Each step's update of each fitted leaf in the port against the
    reference's update from the same step: a fit's first step within
    `_assert_adam_close`, a later one within `_assert_later_step_close`;
    both fits start from the same leaves."""
    assert len(t_steps) == len(j_steps)
    first_t, first_j = t_steps[0]["before"], j_steps[0]["before"]
    assert first_t.keys() == first_j.keys()
    for k, v in first_j.items():
        assert np.array_equal(first_t[k], v), k
    for t, j in zip(t_steps, j_steps):
        key = (t["stage"], t["step"], t["groups"])
        assert key == (j["stage"], j["step"], j["groups"])
        lrs = tstep.group_lrs(t["lcfg"], t["step"], t["stage"], t["groups"])
        for k, j_after in j["after"].items():
            lr, g_ref = lrs[topt.leaf_group(k)], torch.from_numpy(j["grad"][k])
            if t["step"] == 1:
                ref = t["before"][k] + (j_after - j["before"][k])
                _assert_adam_close(torch.from_numpy(t["after"][k]),
                                   torch.from_numpy(ref), g_ref, lr, (key, k))
            else:
                _assert_later_step_close(
                    torch.from_numpy(t["after"][k] - t["before"][k]),
                    torch.from_numpy(j_after - j["before"][k]),
                    torch.from_numpy(j_after), g_ref, lr, (key, k))


def _assert_step_metrics_close(t, j, what):
    assert set(j) <= set(t), set(j) - set(t)
    for k, v in j.items():
        rtol = GRAD_RTOL if k.startswith("grad_") else METRIC_RTOL
        np.testing.assert_allclose(t[k], v, rtol=rtol, atol=1e-7,
                                   err_msg=f"{what} {k}")


def _assert_metrics_close(t_log, j_log):
    assert len(t_log) == len(j_log) == ITERS
    for it, (t, j) in enumerate(zip(t_log, j_log)):
        _assert_step_metrics_close(t, j, f"iteration {it + 1}")


def _assert_fitted_is_last_step(tt, jt, steps):
    """Each trainer holds the leaves its fit's last step wrote."""
    for which, tr in (("torch", tt), ("jax", jt)):
        last = steps[which][-1]["after"]
        got = _fit_leaves(which, tr.state.params)
        assert got.keys() == last.keys()
        for k, v in last.items():
            assert np.array_equal(got[k], v), (which, k)


def _moved(before: dict, tr) -> list:
    after = topt.named_leaves(tr.state.params)
    return sorted(k for k, v in before.items()
                  if k not in after or not torch.equal(v, after[k].detach()))


@pytest.fixture(scope="module")
def latent_fit(ckpt, motion, tmp_path_factory):  # noqa: F811
    """`finetune_latent_to_motion(fresh_latent=False, iters=2)` with LPIPS
    on, in both packages."""
    jt, tt = trainers(ckpt, tmp_path_factory.mktemp("fit"))
    jt.load_checkpoint("s2")
    tt.load_checkpoint("s2")
    before = {k: v.detach().clone()
              for k, v in topt.named_leaves(tt.state.params).items()}
    start = tt.state.params.latent["codes"][:1].detach().clone()
    calls = {"jax": [], "torch": []}
    logs = {"jax": [], "torch": []}
    steps = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as mp:
        _record_batches(mp, calls)
        _record_steps(mp, steps)
        jm = jtm.finetune_latent_to_motion(
            jt, *motion, iters=ITERS, fresh_latent=False,
            lpips_fn=jlpips.random_init_lpips(0),
            log_fn=lambda it, m: logs["jax"].append(_scalars(m)))
        tm = ttm.finetune_latent_to_motion(
            tt, *motion, iters=ITERS, fresh_latent=False,
            lpips_fn=tlpips.random_init_lpips(0, "cpu"),
            log_fn=lambda it, m: logs["torch"].append(_scalars(m)))
    return dict(jt=jt, tt=tt, before=before, start=start, calls=calls,
                logs=logs, steps=steps, jm=_scalars(jm), tm=_scalars(tm))


def test_finetune_samples_the_same_batches(latent_fit):
    calls = latent_fit["calls"]
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) == ITERS
    for views, frames in calls["jax"]:
        assert views[0] == 0 and len(views) == 2 and len(frames) == 1
    assert latent_fit["tt"].py_rng.getstate() == \
        latent_fit["jt"].py_rng.getstate()


def test_finetune_metrics_match_jax(latent_fit):
    _assert_metrics_close(latent_fit["logs"]["torch"],
                          latent_fit["logs"]["jax"])
    assert latent_fit["tm"] == latent_fit["logs"]["torch"][-1]
    assert all(m["lpips"] > 0 for m in latent_fit["logs"]["torch"])


def test_finetune_latent_matches_jax_and_only_it_moves(latent_fit):
    tt, jt, steps = latent_fit["tt"], latent_fit["jt"], latent_fit["steps"]
    assert len(steps["jax"]) == ITERS
    assert all(s["groups"] == ttm.LATENT_GROUPS for s in steps["torch"])
    _assert_steps_close(steps["torch"], steps["jax"])
    _assert_fitted_is_last_step(tt, jt, steps)
    got = tt.state.params.latent["codes"].detach()
    assert got.shape == (1, 8)
    assert not torch.equal(got, latent_fit["start"])
    moved = _moved(latent_fit["before"], tt)
    assert moved == ["latent.codes"], moved


@pytest.fixture(scope="module")
def unaligned(ckpt, motion, tmp_path_factory):  # noqa: F811
    """`run_test_unaligned_motion(iters_a=2, iters_b=2)` in both packages,
    with the state after phase A (`_finetune_cpt_only`) recorded."""
    tmp = tmp_path_factory.mktemp("unaligned")
    jt, tt = trainers(ckpt, tmp)
    tt.load_checkpoint("s2")
    before = {k: v.detach().clone()
              for k, v in topt.named_leaves(tt.state.params).items()}
    codes = np.random.RandomState(11).randn(1, 8).astype(np.float32)
    phase_a, logs, seqs = {}, {"jax": [], "torch": []}, {}
    steps = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as mp:
        _fix_fresh_codes(mp, codes)
        _record_steps(mp, steps)
        for which, mod in (("jax", jtm), ("torch", ttm)):
            real = mod._finetune_cpt_only

            def cpt_only(tr, *a, real=real, which=which, **k):
                m = real(tr, *a, **k)
                phase_a[which] = (_scalars(m),
                                  _fit_leaves(which, tr.state.params))
                return m
            mp.setattr(mod, "_finetune_cpt_only", cpt_only)

            def render_sequence(*a, real=mod.render_sequence, which=which,
                                **k):
                seqs[which] = real(*a, **k)
                return seqs[which]
            mp.setattr(mod, "render_sequence", render_sequence)
        jm = jtm.run_test_unaligned_motion(
            jt, *motion, iters_a=ITERS, iters_b=ITERS,
            log_fn=lambda it, m: logs["jax"].append(_scalars(m)))
        tm = ttm.run_test_unaligned_motion(
            tt, *motion, iters_a=ITERS, iters_b=ITERS,
            log_fn=lambda it, m: logs["torch"].append(_scalars(m)))
    return dict(jt=jt, tt=tt, tmp=tmp, before=before, codes=codes,
                phase_a=phase_a, logs=logs, seqs=seqs, steps=steps,
                jm=_scalars(jm), tm=_scalars(tm))


def test_cpt_only_phase_matches_jax(unaligned):
    """Phase A: its steps, and the grafted latent and TimeNet are its last
    step's."""
    (t_m, t_fit), (j_m, j_fit) = (unaligned["phase_a"]["torch"],
                                  unaligned["phase_a"]["jax"])
    _assert_step_metrics_close(t_m, j_m, "phase A")
    steps = unaligned["steps"]
    groups = ttm.LATENT_GROUPS | {"deform", "deform_rot"}
    assert [(s["stage"], s["groups"]) for s in steps["torch"][:ITERS]] == \
        [("s1", groups)] * ITERS
    _assert_steps_close(steps["torch"][:ITERS], steps["jax"][:ITERS])
    for which, fit in (("torch", t_fit), ("jax", j_fit)):
        last = steps[which][ITERS - 1]["after"]
        assert fit.keys() == last.keys()
        for k, v in last.items():
            assert np.array_equal(fit[k], v), (which, k)
    assert not np.array_equal(t_fit["latent.codes"], unaligned["codes"])


def test_unaligned_motion_matches_jax(unaligned):
    _assert_metrics_close(unaligned["logs"]["torch"], unaligned["logs"]["jax"])
    tt, jt, steps = unaligned["tt"], unaligned["jt"], unaligned["steps"]
    assert [s["stage"] for s in steps["jax"]] == ["s1"] * ITERS + \
        ["s2"] * ITERS
    _assert_steps_close(steps["torch"], steps["jax"])
    _assert_fitted_is_last_step(tt, jt, steps)
    assert_frames_close(np.stack(unaligned["seqs"]["torch"]),
                        np.stack(unaligned["seqs"]["jax"]), "unaligned")
    # only the latent and TimeNet moved
    moved = _moved(unaligned["before"], tt)
    assert moved and all(k.startswith(("latent.", "timenet.")) for k in moved)
    assert "latent.codes" in moved and any(k.startswith("timenet.")
                                           for k in moved)


def test_motion_mode_trains_only_the_latent(ckpt, motion, tmp_path,  # noqa: F811
                                            written):
    """`run_test_motion` in the port: a fresh latent fitted for 2
    iterations, every other leaf as the checkpoint left it, the
    reference's video names."""
    _, tt = trainers(ckpt, tmp_path)
    tt.load_checkpoint("s2")
    before = {k: v.detach().clone()
              for k, v in topt.named_leaves(tt.state.params).items()}
    m = ttm.run_test_motion(tt, *motion, iters=ITERS)
    assert np.isfinite(float(m["loss"]))
    assert _moved(before, tt) == ["latent.codes"]
    assert tt.state.params.latent["codes"].shape == (1, 8)
    assert {"render_images.mp4", "render_images_diag.mp4", "blend_blend.mp4",
            "run_test_motion_cpts_0.mp4"} <= set(written["torch"])


def _write_projector(tmp_path, kind, w, b):
    path = str(tmp_path / f"proj.{kind}")
    if kind == "npz":
        np.savez(path, weight=w, bias=b)
    elif kind == "pth":
        torch.save({"projection.0.weight": torch.from_numpy(w.T.copy()),
                    "projection.0.bias": torch.from_numpy(b)}, path)
    else:                      # a whole module, as the reference saves it
        m = torch.nn.Module()
        m.projection = torch.nn.Sequential(torch.nn.Linear(768, w.shape[1]))
        with torch.no_grad():
            m.projection[0].weight.copy_(torch.from_numpy(w.T.copy()))
            m.projection[0].bias.copy_(torch.from_numpy(b))
        path = str(tmp_path / "proj_module.pth")
        torch.save(m, path)
    return path


@pytest.mark.parametrize("kind", ["npz", "pth", "module", "missing"])
def test_mlp_projector_matches_jax(tmp_path, kind):
    rng = np.random.RandomState(2)
    dim = 32
    w = (rng.randn(768, dim) * 0.05).astype(np.float32)
    b = rng.randn(dim).astype(np.float32)
    path = (str(tmp_path / "absent.pth") if kind == "missing"
            else _write_projector(tmp_path, kind, w, b))
    jp = jtext.load_mlp_projector(path, latent_dim=dim)
    tp = ttext.load_mlp_projector(path, latent_dim=dim, device="cpu")
    assert np.array_equal(tp.weight.numpy(), np.asarray(jp.weight))
    assert np.array_equal(tp.bias.numpy(), np.asarray(jp.bias))
    assert tp.weight.shape == (768, dim)
    if kind != "missing":
        assert np.array_equal(tp.weight.numpy(), w)
    emb = rng.randn(768).astype(np.float32)
    got = tp(torch.from_numpy(emb)).numpy()
    ref = np.asarray(jp(jnp.asarray(emb)))
    bound = 768 * U32 * (np.abs(emb) @ np.abs(tp.weight.numpy())) + 1e-30
    assert (np.abs(got - ref) <= bound).all(), float(np.abs(got - ref).max())


def test_language_mode_matches_jax(ckpt, tmp_path, written):  # noqa: F811
    """A precomputed (1, 768) embedding in a .npy, as the CLI reads it,
    through the seeded projector."""
    path = str(tmp_path / "emb.npy")
    np.save(path, np.random.RandomState(4).randn(1, 768).astype(np.float32))
    emb = np.load(path)[0]
    jt, tt = trainers(ckpt, tmp_path)
    ref = jtm.run_test_language(jt, "a person waves", text_emb=emb)
    got = ttm.run_test_language(tt, "a person waves", text_emb=emb)
    j_code = np.asarray(jt.state.params.latent["codes"])
    t_code = tt.state.params.latent["codes"].numpy()
    proj = ttext.load_mlp_projector(None, latent_dim=8, device="cpu")
    bound = 768 * U32 * (np.abs(emb) @ np.abs(proj.weight.numpy())) + 1e-30
    assert t_code.shape == j_code.shape == (1, 8)
    assert (np.abs(t_code - j_code) <= bound).all()
    assert_frames_close(np.stack(got), np.stack(ref), "language")
    assert sorted(written["torch"]) == sorted(written["jax"])
    assert "a person waves_blend.mp4" in written["torch"]
