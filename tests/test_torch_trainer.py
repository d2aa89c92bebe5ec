"""The port's two-stage `Trainer` against `dimo_tpu.train.loop.Trainer`,
on the CPU, at `tiny_synthetic_opt`'s size (2 motions x 3 views x 5 frames
of 64x64 video, 24 Gaussians in a capacity of 64, 128x128 renders).

Same seed, same batches: both trainers draw frames and views from
`random.Random(seed)` and motions from the global `np.random`, which each
constructor reseeds, so a trainer is built and drawn from before the other
one is built. Model state is carried from the JAX trainer into the port's
(`io/convert.py`), since the two packages initialise TimeNet and the
latents from different generators.

Tolerances: batch tuples, `prepare_train_s2`'s Gaussians and control
points, and checkpoint round trips through both packages exactly;
three s1 steps' losses 1e-3 relative (Adam's first steps move an element
by about its learning rate whatever its gradient's size, so the two
states drift apart by rounding); the cached s1 trajectories 1e-5; the
synthetic videos within one uint8 level on at least 99.9% of the pixels
(the cast truncates, so a last-bit difference at a level boundary is a
step of 1).
"""
import os

import jax
import numpy as np
import pytest
import torch

from dimo_tpu.io.synthetic import make_synthetic_videos as j_synthetic
from dimo_tpu.presets import tiny_synthetic_opt as j_opt
from dimo_tpu.train.loop import Trainer as JTrainer

from dimo_tpu_torch.io import checkpoint as tckpt
from dimo_tpu_torch.io.convert import params_from_numpy
from dimo_tpu_torch.io.synthetic import make_synthetic_videos as t_synthetic
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.presets import tiny_synthetic_opt as t_opt
from dimo_tpu_torch.train import optim as topt
from dimo_tpu_torch.train import step as tstep
from dimo_tpu_torch.train.loop import Trainer as TTrainer

from test_torch_math import jax_to_numpy
from torch_parity import one_torch_thread  # noqa: F401

PER_G = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
         "opacity")


@pytest.fixture(scope="module")
def data():
    return t_synthetic(num_motions=2, num_views=3, num_frames=5, ref_size=64,
                       n_gauss=40, seed=0, device="cpu")


def port_trainer(data, **kw):
    return TTrainer(t_opt(**kw), *data, device="cpu")


def carry_state(jt, tt):
    """Put the JAX trainer's model state into the port's trainer."""
    tp, ta = params_from_numpy(jax_to_numpy(jt.state.params, jt.state.aux),
                               device="cpu")
    tt.state = tstep.init_state(tp, ta, step=int(jt.state.step), seed=tt.seed)


def leaves_np(tr):
    """Active rows of the per-Gaussian leaves + control points, numpy."""
    p, a = tr.state.params, tr.state.aux
    as_np = lambda x: (x.detach().numpy() if isinstance(x, torch.Tensor)  # noqa: E731
                       else np.asarray(x))
    act, c_act = as_np(a.active), as_np(a.c_active)
    out = {f: as_np(getattr(p, f))[act] for f in PER_G}
    out["c_xyz"] = as_np(p.c_xyz)[c_act]
    out["c_radius"] = as_np(p.c_radius)[c_act]
    return out


def test_synthetic_videos_match_jax(data):
    images, masks, meta = data
    j_images, j_masks, j_meta = j_synthetic(
        num_motions=2, num_views=3, num_frames=5, ref_size=64, n_gauss=40,
        seed=0)
    assert images.dtype == np.uint8 and images.shape == j_images.shape
    assert masks.shape == j_masks.shape and meta == j_meta
    for got, ref in ((images, j_images), (masks, j_masks)):
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() <= 1
        assert (diff == 0).mean() >= 0.999
    assert masks.max() > 200 and images.std() > 10      # not blank


def test_sample_meta_draws_the_jax_trainers_batches(data):
    jt = JTrainer(j_opt(batch_size=2), *data)
    j_metas = [jt._sample_meta() for _ in range(4)]
    tt = port_trainer(data, batch_size=2)
    t_metas = [tt._sample_meta() for _ in range(4)]
    for j, t in zip(j_metas, t_metas):
        np.testing.assert_array_equal(t["mvf"], j["mvf"])
        np.testing.assert_array_equal(t["flat"], j["flat"])
        assert t["shape"] == j["shape"] == (2, 2, 2)
        assert t["times"] == j["times"] and t["mse_w"] == j["mse_w"]
        for a, b in zip(t["cams"], j["cams"]):
            np.testing.assert_array_equal(a.full_proj, b.full_proj)
    assert len({tuple(m["mvf"].ravel()) for m in t_metas}) > 1


def test_check_overflow_escalates_like_the_reference(data):
    """The sequence of `tests/test_train_smoke.py`'s escalation test."""
    tr = port_trainer(data)
    cap0 = tr.tile_capacity
    tr._last_b = 4
    heavy, light = {"overflow": 4 * cap0}, {"overflow": 0.0}
    for step, m in ((10, heavy), (20, heavy), (30, light)):
        tr.step = step
        tr._check_overflow(m)
    assert tr.tile_capacity == cap0              # transient: no escalation
    for step in (40, 50, 60):
        tr.step = step
        tr._check_overflow(heavy)
    assert tr.tile_capacity == cap0 * 2          # sustained: doubled
    tr.step = 61
    tr._check_overflow(heavy)
    assert tr.tile_capacity == cap0 * 2          # off-cadence steps do not count
    # one strip dropping > 25% of its capacity counts on its own
    for step in (70, 80, 90):
        tr.step = step
        tr._check_overflow({"overflow": 0.0,
                            "overflow_max": 0.3 * tr.tile_capacity})
    assert tr.tile_capacity == cap0 * 4
    step, heavy = 100, {"overflow": 4 * 4096}
    while tr.tile_capacity < 4096 and step < 1000:
        tr.step = step
        tr._check_overflow(heavy)
        step += 10
    assert tr.tile_capacity == 4096
    for _ in range(3):
        tr.step = step
        tr._check_overflow(heavy)
        step += 10
    assert tr.tile_capacity == 4096              # and stops at the ceiling


def test_three_s1_steps_track_the_jax_trainer(data):
    jt = JTrainer(j_opt(), *data)
    jt.prepare_train_s1()
    j_losses = []
    jt.log_fn = lambda s, st, m: j_losses.append(float(m["loss"]))
    j_start = jax.tree.map(np.asarray, (jt.state.params, jt.state.aux))
    for _ in range(3):
        jt.train_step_once()

    tt = port_trainer(data)
    tt.prepare_train_s1()
    tp, ta = params_from_numpy(jax_to_numpy(*j_start), device="cpu")
    tt.state = tstep.init_state(tp, ta, step=0)
    t_log = []
    tt.log_fn = lambda s, st, m: t_log.append((s, st, float(m["loss"])))
    for _ in range(3):
        tt.train_step_once()
    assert [(s, st) for s, st, _ in t_log] == [("s1", 1), ("s1", 2), ("s1", 3)]
    np.testing.assert_allclose([x[2] for x in t_log], j_losses, rtol=1e-3)
    assert tt.state.step == 3 == int(jt.state.step)
    assert list(tt._step_fns) == [("s1", 128, (2, 1, 1), 64)]


@pytest.fixture(scope="module")
def s2_pair(data, tmp_path_factory):
    """Both trainers taken through finish_s1 + prepare_train_s2 from one s1
    state with a few slots pruned."""
    root = tmp_path_factory.mktemp("s2_pair")
    jt = JTrainer(j_opt(save_path=str(root / "jax")), *data)
    active = np.asarray(jt.state.aux.active).copy()
    active[[2, 5, 17]] = False
    jt.state = jt.state.replace(aux=jt.state.aux.replace(
        active=jax.numpy.asarray(active)))
    tt = port_trainer(data, save_path=str(root / "port"))
    carry_state(jt, tt)
    for tr in (jt, tt):
        tr.finish_s1()
        tr.prepare_train_s2()
    return jt, tt


def test_prepare_train_s2_matches_jax(s2_pair):
    jt, tt = s2_pair
    assert tt.stage == "s2" and tt.step == 0 and tt.state.step == 0
    assert tt.mcfg.capacity == jt.mcfg.capacity == 2048
    assert tt.mcfg.cpt_capacity == jt.mcfg.cpt_capacity == 24
    ja, ta = jt.state.aux, tt.state.aux
    np.testing.assert_array_equal(ta.active.numpy(), np.asarray(ja.active))
    np.testing.assert_array_equal(ta.c_active.numpy(), np.asarray(ja.c_active))
    assert int(TG.num_active(ta)) == 21 * 4
    jp, tp = jt.state.params, tt.state.params
    for f in ("xyz", "c_xyz", "c_radius", "features_dc", "rotation", "opacity",
              "r"):
        np.testing.assert_array_equal(getattr(tp, f).detach().numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    # log of a 3-NN mean distance: matmul sums round differently
    np.testing.assert_allclose(tp.scaling.detach().numpy(),
                               np.asarray(jp.scaling), rtol=1e-4, atol=1e-4)
    # a fresh optimizer over the new leaves
    assert int(tt.state.opt.step) == 0
    assert tt.state.opt.mu["xyz"].shape == tp.xyz.shape and tp.xyz.requires_grad
    assert not bool(tt.state.opt.mu["timenet.trunk.0.weight"].any())


def test_cached_s1_trajectories_match_jax(s2_pair):
    jt, tt = s2_pair
    assert tt.cpts_s1.shape == jt.cpts_s1.shape == (2, 5, 24, 3)
    np.testing.assert_allclose(tt.cpts_s1, jt.cpts_s1, rtol=1e-5, atol=1e-5)
    # a trained TimeNet moves the points: seeded heads instead of zeros
    rng = np.random.RandomState(0)
    with torch.no_grad():
        tt.state.params.timenet.pts_1.weight.copy_(torch.from_numpy(
            (rng.randn(3, 256) * 0.02).astype(np.float32)))
    before = tt.cpts_s1.copy()
    tt.cache_s1_trajectories()
    assert np.abs(tt.cpts_s1 - before).max() > 1e-4
    assert np.abs(tt.cpts_s1[0, 0] - tt.cpts_s1[0, 3]).max() > 1e-5
    with torch.no_grad():
        tt.state.params.timenet.pts_1.weight.zero_()
    tt.cache_s1_trajectories()


@pytest.mark.parametrize("stage", ["s1", "s2"])
def test_checkpoints_load_both_ways(s2_pair, data, stage):
    jt, tt = s2_pair
    if stage == "s2":
        for tr in (jt, tt):
            tr.save_checkpoint("s2")
    # both wrote the same files for the stage
    names = lambda tr: sorted(os.listdir(os.path.join(  # noqa: E731
        tr.opt.save_path, stage)))
    assert names(jt) == names(tt) and "timenet.pth" in names(tt)
    # the port's directory in the JAX trainer, and the reverse
    j_reader = JTrainer(j_opt(save_path=tt.opt.save_path), *data)
    j_reader.load_checkpoint(stage)
    t_reader = port_trainer(data, save_path=jt.opt.save_path)
    t_reader.load_checkpoint(stage)
    got, ref = leaves_np(t_reader), leaves_np(j_reader)
    for f in got:
        assert got[f].shape == ref[f].shape and got[f].shape[0] > 0, f
        tol = 1e-4 if f == "scaling" and stage == "s2" else 0
        np.testing.assert_allclose(got[f], ref[f], rtol=tol, atol=tol,
                                   err_msg=f)
    assert t_reader.mcfg.capacity == j_reader.mcfg.capacity
    # TimeNet and latents through the npz twins, and through the .pth alone
    j_net = {k: np.asarray(v) for k, v in j_reader.state.params.timenet.items()}
    from dimo_tpu_torch.io.convert import timenet_to_numpy
    t_net = timenet_to_numpy(t_reader.state.params.timenet)
    assert j_net.keys() == t_net.keys()
    for k in j_net:
        np.testing.assert_array_equal(t_net[k], j_net[k], err_msg=k)
    np.testing.assert_array_equal(
        t_reader.state.params.latent["codes"].detach().numpy(),
        np.asarray(j_reader.state.params.latent["codes"]))
    pth_only = os.path.join(tt.opt.save_path, stage + "_pth")
    os.makedirs(pth_only, exist_ok=True)
    for n in ("timenet.pth", "latent_codes.pth"):
        with open(os.path.join(jt.opt.save_path, stage, n), "rb") as src, \
                open(os.path.join(pth_only, n), "wb") as dst:
            dst.write(src.read())
    lat, net = tckpt.load_model(pth_only, device="cpu")
    for k, v in timenet_to_numpy(net).items():
        np.testing.assert_array_equal(v, j_net[k], err_msg=k)
    assert torch.equal(lat["codes"],
                       t_reader.state.params.latent["codes"].detach())


def test_snapshot_resumes_in_a_fresh_trainer(data, tmp_path):
    snap = str(tmp_path / "snap")
    opt = dict(save_path=str(tmp_path / "run"))
    tr = port_trainer(data, **opt)
    tr.prepare_train_s1()
    for _ in range(4):
        tr.train_step_once()
    tr.tile_capacity = 128
    tr.save_snapshot(snap, "s1", 4)
    assert tr.peek_snapshot_phase(snap) == "s1"

    fresh = port_trainer(data, **opt)
    meta = fresh.load_snapshot(snap)
    assert meta["phase"] == "s1" and meta["done"] == 4
    assert fresh.step == 4 == fresh.state.step and fresh.stage == "s1"
    assert fresh.tile_capacity == 128
    assert int(fresh.state.opt.step) == int(tr.state.opt.step) == 4
    a, b = topt.named_leaves(tr.state.params), topt.named_leaves(fresh.state.params)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k].detach(), b[k].detach()), k
        assert torch.equal(tr.state.opt.mu[k], fresh.state.opt.mu[k]), k
        assert torch.equal(tr.state.opt.nu[k], fresh.state.opt.nu[k]), k
        assert b[k].requires_grad
    for f in ("active", "c_active", "denom", "xyz_grad_accum", "max_radii2d"):
        assert torch.equal(getattr(tr.state.aux, f), getattr(fresh.state.aux, f))
    assert torch.equal(tr.state.rng.get_state(), fresh.state.rng.get_state())

    # train_dynamic continues at step 5, finishes s1, runs s2, retires the
    # snapshot
    runner = port_trainer(data, **opt)
    log = []
    runner.log_fn = lambda s, st, m: log.append((s, st))
    runner.train_dynamic(6, 3, snapshot_every=2, snapshot_dir=snap)
    assert log == [("s1", 5), ("s1", 6), ("s2", 1), ("s2", 2), ("s2", 3)]
    assert port_trainer(data, **opt).load_snapshot(snap) is None
    # a lowered ceiling clamps a resumed capacity; Inf moments are zeroed
    tr.state.opt.nu["xyz"][0, 0] = float("inf")
    tr.save_snapshot(snap, "s1", 4)
    low = port_trainer(data, tile_capacity_max=96, **opt)
    assert low.load_snapshot(snap) is not None
    assert low.tile_capacity == 96
    assert float(low.state.opt.nu["xyz"][0, 0]) == 0.0


def test_inconsistent_snapshot_is_refused(data, tmp_path, capsys):
    """state.step != meta.step (a crash between the renames): ignored."""
    snap = str(tmp_path / "snap")
    tr = port_trainer(data, save_path=str(tmp_path / "run"))
    tr.prepare_train_s1()
    tr.save_snapshot(snap, "s1", 0)
    tr.step = 7                              # meta of a later generation
    import json
    with open(os.path.join(snap, "snapshot_meta.json")) as f:
        meta = json.load(f)
    meta["step"] = 7
    with open(os.path.join(snap, "snapshot_meta.json"), "w") as f:
        json.dump(meta, f)
    fresh = port_trainer(data, save_path=str(tmp_path / "run"))
    assert fresh.load_snapshot(snap) is None
    assert "IGNORED inconsistent snapshot" in capsys.readouterr().out
    assert fresh.step == 0
    assert not os.path.exists(os.path.join(snap, "tmp_snapshot_state.npz"))


def test_load_stage_overrides_a_stale_snapshot(data, tmp_path):
    snap = str(tmp_path / "snap")
    opt = dict(save_path=str(tmp_path / "run"))
    tr = port_trainer(data, **opt)
    tr.prepare_train_s1()
    for _ in range(2):
        tr.train_step_once()
    tr.finish_s1()
    tr.save_snapshot(snap, "s1", 2)
    runner = port_trainer(data, **opt)
    log = []
    runner.log_fn = lambda s, st, m: log.append((s, st))
    runner.train_dynamic(6, 2, load_stage="s1", snapshot_every=2,
                         snapshot_dir=snap)
    assert log == [("s2", 1), ("s2", 2)]


def test_train_dynamic_runs_every_cadence_event(data, tmp_path):
    """A short run in which each event of the cadence happens: densify,
    opacity reset, FPS anneal, finish_s1's prune and checkpoint, the s2
    prune, a mid-run checkpoint, and the final s2 checkpoint read back."""
    opt = t_opt(save_path=str(tmp_path / "run"), FPS_iter=8,
                density_start_iter=2, density_end_iter=100,
                densification_interval=3, opacity_reset_interval=6,
                densification_interval_s2=2, save_inter=4, capacity_s1=64)
    tr = TTrainer(opt, *data, device="cpu")
    events = []
    tr.log_fn = lambda s, st, m: events.append(
        (s, st, int(TG.num_active(tr.state.aux)), float(m["loss"]),
         float(torch.sigmoid(tr.state.params.opacity.detach()).max())))
    tr.train_dynamic(10, 4)
    counts = {(s, st): n for s, st, n, _, _ in events}
    assert all(np.isfinite(e[3]) for e in events)
    assert counts[("s1", 4)] > counts[("s1", 3)] == 24       # densify at 3
    assert tr.mcfg.capacity > 32 or counts[("s1", 4)] <= 0.9 * 32
    assert events[5][4] > 0.05 and events[6][4] < 0.02       # reset at 6
    assert counts[("s1", 9)] <= 24                           # FPS at 8
    assert tr.stage == "s2" and tr.step == 4
    assert tr.cpts_s1.shape[:2] == (2, 5)
    run = str(tmp_path / "run")
    assert os.path.exists(os.path.join(run, "s1", "point_cloud_8.ply"))
    assert os.path.exists(os.path.join(run, "s2", "point_cloud_c_4.ply"))
    back = TTrainer(opt, *data, device="cpu")
    back.load_checkpoint("s2")
    assert int(TG.num_active(back.state.aux)) == int(TG.num_active(tr.state.aux))
    np.testing.assert_array_equal(leaves_np(back)["xyz"], leaves_np(tr)["xyz"])


def test_device_batch_matches_host_batch(s2_pair):
    tt = s2_pair[1]
    assert tt._dev_images is not None            # tiny data: kept as tensors
    meta = tt._sample_meta()
    tt._pending_meta = dict(meta)
    dev_batch, dev_shape = tt.sample_batch()
    held = tt._dev_images, tt._dev_masks
    try:
        tt._dev_images = tt._dev_masks = None
        tt._pending_meta = dict(meta)
        host_batch, host_shape = tt.sample_batch()
    finally:
        tt._dev_images, tt._dev_masks = held
    assert dev_shape == host_shape
    assert dev_batch.keys() == host_batch.keys() and "guidance" in dev_batch
    for k in ("gt_image", "gt_mask", "guidance"):
        assert torch.equal(dev_batch[k], host_batch[k]), k
    np.testing.assert_array_equal(
        dev_batch["gt_image"].numpy(),
        tt.images.reshape(-1, 64, 64, 3)[meta["flat"]])
    np.testing.assert_array_equal(
        dev_batch["guidance"].numpy(),
        tt.cpts_s1[meta["mvf"][:, 0], meta["mvf"][:, 2]])


def test_lpips_and_data_parallel_are_refused(data):
    with pytest.raises(NotImplementedError, match="data_parallel"):
        port_trainer(data, data_parallel=2)
    tr = port_trainer(data)
    for call in (lambda: tr.train_dynamic(1, 0, lpips_fn=lambda a, b: a),
                 lambda: tr.train_step_once(lpips_fn=lambda a, b: a)):
        with pytest.raises(NotImplementedError, match="LPIPS"):
            call()
