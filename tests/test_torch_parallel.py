"""The port's data and spatial parallelism (`dimo_tpu_torch/parallel/`),
on the CPU, with two gloo ranks spawned per test
(`parallel/check.py`'s workers, a `file://` rendezvous under the test's
temporary directory, a hard timeout on every rank).

Tolerances:
  * data_parallel=2 against a Trainer without a mesh, each step from one
    state: loss 1e-5 relative; every all-reduced gradient leaf of the first
    s1 and s2 steps within 1e-3 relative L2 (the ranks add their halves in
    another order); both ranks' parameters, moments, `denom`,
    `max_radii2d` and the cached trajectories bit-identical, after a
    densification, `finish_s1` and `prepare_train_s2`;
  * data_parallel=2 against `dimo_tpu`'s Trainer at data_parallel=2 on
    conftest's 8 CPU devices: `test_torch_trainer.py`'s 1e-3 on the
    losses (Adam's first steps move an element by about its learning rate
    whatever its gradient's size);
  * the render sharded over two ranks: image and depth equal to the
    unsharded render bit for bit (each pixel has one non-zero addend);
    within `test_torch_render.py`'s 1e-4 of `dimo_tpu`'s
    `rasterize(sp_mesh=make_sp_mesh(2))` except at alpha-cut flips;
    gradients within the reference's own bound for its sharded render,
    rtol 5e-3 / atol 1e-2 (`tests/test_multichip.py`), the measured error
    printed.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.parallel import check
from dimo_tpu_torch.parallel import mesh as mesh_mod
from dimo_tpu_torch.presets import tiny_synthetic_opt as t_opt
from dimo_tpu_torch.train.loop import Trainer as TTrainer

from torch_parity import assert_close_except_cut_flips
from torch_parity import one_torch_thread  # noqa: F401

SPAWN_TIMEOUT_S = 150
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_l2(got, ref) -> float:
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def test_meshes_raise_without_enough_ranks(tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        mesh_mod.make_mesh(2)
    with pytest.raises(ValueError, match="spatial_parallel=2 needs one"):
        mesh_mod.make_sp_mesh(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="only 1 ranks"):
            mesh_mod.make_mesh(2)
        with pytest.raises(ValueError, match="only 1 ranks"):
            mesh_mod.make_sp_mesh(4)
        m = mesh_mod.make_mesh(1)
        assert (m.rank, m.size, m.device.type) == (0, 1, "cpu")
        # a one-rank mesh's collectives are the identity
        x = torch.arange(5.0)
        mesh_mod.sum_flat_([x], m)
        assert torch.equal(x, torch.arange(5.0))
        rows = mesh_mod.shard_batch({"times": [1, 2], "latent_idx": [0, 1],
                                     "other": (3, 4)}, m)
        assert rows == {"times": [1, 2], "latent_idx": [0, 1],
                        "latent_idx_all": [0, 1], "other": (3, 4)}
    finally:
        dist.destroy_process_group()


def test_shard_batch_takes_contiguous_rows():
    m = mesh_mod.Mesh(rank=1, size=2, device=torch.device("cpu"))
    batch = {"times": np.arange(6.0), "camera": list("abcdef"),
             "gt_image": torch.arange(12).reshape(6, 2), "shape": (3, 1, 2),
             "latent_idx": np.repeat([0, 1, 2], 2)}
    out = mesh_mod.shard_batch(batch, m)
    np.testing.assert_array_equal(out["times"], [3.0, 4.0, 5.0])
    assert out["camera"] == ["d", "e", "f"]
    assert torch.equal(out["gt_image"], torch.arange(6, 12).reshape(3, 2))
    assert out["shape"] == (3, 1, 2)
    np.testing.assert_array_equal(out["latent_idx"], [1, 2, 2])
    # the whole batch's motions, for the terms of the parameters alone
    np.testing.assert_array_equal(out["latent_idx_all"], [0, 0, 1, 1, 2, 2])
    again = mesh_mod.shard_batch(dict(batch, latent_idx_all=np.arange(6)), m)
    np.testing.assert_array_equal(again["latent_idx_all"], np.arange(6))


def test_indivisible_batch_raises():
    """`tests/test_multichip.py`'s indivisible batch: 2 render jobs over
    more ranks than divide them."""
    data = make_synthetic_videos(num_motions=3, num_views=3, num_frames=5,
                                 ref_size=64, n_gauss=40, seed=0, device="cpu")
    tr = TTrainer(t_opt(batch_size=1), *data, device="cpu")
    tr.mesh = mesh_mod.Mesh(rank=0, size=4, device=torch.device("cpu"))
    tr.prepare_train_s1()
    with pytest.raises(ValueError, match="divisible"):
        tr.train_step_once()


def _spawn(fn, tmp_path, kw, world=2):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    check.spawn(fn, world, (str(tmp_path / "rdv"), str(out), kw),
                SPAWN_TIMEOUT_S)
    ranks = [dict(np.load(out / f"rank{r}.npz", allow_pickle=True))
             for r in range(world)]
    return out, ranks


def _assert_ranks_identical(ranks, prefixes):
    a, b = ranks
    keys = [k for k in a if k.startswith(prefixes)]
    assert keys and set(keys) <= set(b)
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("vae", [False, True])
def test_data_parallel_trainer_matches_one_rank(tmp_path, vae):
    """Three motions x 2 views x 2 frames: 12 jobs, 6 a rank, so motion 1
    straddles the ranks. Two s1 steps (statistics gathered from step 1, a
    densification at step 2), finish_s1, prepare_train_s2, two s2 steps
    (ARAP, guidance and the cached trajectories). With the VAE latent,
    every render draws its noise from the step's generator: each rank
    draws and drops the other rank's jobs' noise, so job b's noise and
    the ranks' states stay those of one rank."""
    kw = {"data": dict(num_motions=3, num_views=3, num_frames=5, ref_size=64,
                       n_gauss=40, seed=0),
          "opt": dict(batch_size=2, density_start_iter=0,
                      densification_interval=2, vae_latent=vae,
                      save_path=str(tmp_path / "run")),
          "s1_steps": 2, "s2_steps": 2}
    out, ranks = _spawn(check.dp_trainer_worker, tmp_path, kw)
    steps = json.loads((out / "log.json").read_text())["steps"]
    assert [(s["stage"], s["step"]) for s in steps] == [
        ("s1", 1), ("s1", 2), ("s2", 1), ("s2", 2)]
    for s in steps:
        np.testing.assert_allclose(s["dp_loss"], s["ref_loss"], rtol=1e-5)
        np.testing.assert_allclose(s["dp_mse"], s["ref_mse"], rtol=1e-5)
        assert s["dp_overflow"] == s["ref_overflow"]
        assert s["dp_overflow_max"] == s["ref_overflow_max"]
    r0 = ranks[0]
    for stage in ("s1first", "s2first"):
        errs = {k[len(stage) + 3:]: rel_l2(r0[k], r0[f"{stage}.ref_g." +
                                               k[len(stage) + 3:]])
                for k in r0 if k.startswith(f"{stage}.g.")}
        print(stage, "gradient relative L2, dp=2 vs dp=1:",
              max(errs.values()))
        assert errs and max(errs.values()) <= 1e-3, errs
    # the statistics were gathered (from the last rank's render) and the
    # densification ran on both ranks alike
    assert r0["s1first.aux.denom"].max() > 0
    assert r0["s1first.aux.max_radii2d"].max() > 0
    assert r0["s1last.aux.active"].sum() != r0["s1first.aux.active"].sum()
    _assert_ranks_identical(ranks, ("s1first.", "s1last.", "s2prep.",
                                    "s2last."))
    for name in ("point_cloud.ply", "latent_codes.npz"):
        assert (tmp_path / "run" / "s1" / name).exists()


@pytest.mark.parametrize("stage", ["s1", "s2"])
def test_data_parallel_trainer_matches_jax(tmp_path, stage):
    """`dimo_tpu`'s Trainer at data_parallel=2 (a mesh of 2 of conftest's 8
    CPU devices) and the port's over two ranks, from the JAX trainer's
    state: s1, three steps; s2, one step from the JAX trainer's
    prepare_train_s2 (one JAX step function compiled a case). ARAP is off:
    its random times come from different generators in the two
    packages."""
    import jax
    from dimo_tpu.presets import tiny_synthetic_opt as j_opt
    from dimo_tpu.train.loop import Trainer as JTrainer
    from test_torch_math import jax_to_numpy

    def state_of(jt):
        return jax_to_numpy(*jax.tree.map(np.asarray, (jt.state.params,
                                                       jt.state.aux)))

    data_kw = dict(num_motions=2, num_views=3, num_frames=5, ref_size=64,
                   n_gauss=40, seed=0)
    data = make_synthetic_videos(device="cpu", **data_kw)
    opt_kw = dict(use_arap=False, save_path=str(tmp_path / "jax"))
    jt = JTrainer(j_opt(data_parallel=2, **opt_kw), *data)
    assert jt.mesh.devices.size == 2
    jt.prepare_train_s1()
    kw = {"data": data_kw,
          "opt": dict(opt_kw, save_path=str(tmp_path / "port")),
          "s1_steps": 3 if stage == "s1" else 0,
          "s2_steps": 1 if stage == "s2" else 0}
    j_losses = []
    jt.log_fn = lambda s, st, m: j_losses.append(float(m["loss"]))
    if stage == "s1":
        kw["start"] = str(tmp_path / "start.npz")
        check.save_start(kw["start"], state_of(jt))
        for _ in range(3):
            jt.train_step_once()
    else:
        jt.finish_s1()
        jt.prepare_train_s2()
        kw["start_s2"] = str(tmp_path / "start_s2.npz")
        check.save_start(kw["start_s2"], state_of(jt),
                         cpts_s1=np.asarray(jt.cpts_s1))
        jt.train_step_once()

    out, ranks = _spawn(check.dp_trainer_worker, tmp_path, kw)
    steps = json.loads((out / "log.json").read_text())["steps"]
    assert [(s["stage"], s["step"]) for s in steps] == (
        [("s1", 1), ("s1", 2), ("s1", 3)] if stage == "s1" else [("s2", 1)])
    np.testing.assert_allclose([s["dp_loss"] for s in steps], j_losses,
                               rtol=1e-3)
    _assert_ranks_identical(ranks, ("s1last.", "s2last."))


def test_sharded_render_is_the_unsharded_render(tmp_path):
    """`tests/test_multichip.py`'s scene (300 Gaussians, 256^2, capacity
    256) rendered with its strips dealt over two ranks."""
    import jax
    import jax.numpy as jnp
    from dimo_tpu.ops.rasterizer import rasterize as j_rasterize
    from dimo_tpu.parallel import mesh as j_mesh
    from dimo_tpu.utils import cameras as j_cameras

    out, ranks = _spawn(check.sp_render_worker, tmp_path,
                        {"device": "cpu", "size": 256, "capacity": 256})
    for r in ranks:
        for f in ("image", "depth", "alpha"):
            np.testing.assert_array_equal(r[f"sp.{f}"], r[f"full.{f}"], f)
        np.testing.assert_array_equal(r["sp3.image"], r["full3.image"])
        np.testing.assert_allclose(float(r["sp.loss"]), float(r["full.loss"]),
                                   rtol=1e-6)
    _assert_ranks_identical(ranks, ("sp.", "sp3."))
    g_sp, g_full = ranks[0]["sp.grad"], ranks[0]["full.grad"]
    print("sharded vs unsharded gradient: max abs",
          float(np.abs(g_sp - g_full).max()), "relative L2",
          rel_l2(g_sp, g_full))
    np.testing.assert_allclose(g_sp, g_full, rtol=5e-3, atol=1e-2)

    rng = np.random.RandomState(7)
    n = 300
    means = jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)), jnp.float32)
    scales = jnp.asarray(np.exp(rng.uniform(-4.0, -2.5, (n, 3))), jnp.float32)
    quats = jnp.asarray(rng.randn(n, 4), jnp.float32)
    opac = jnp.asarray(rng.uniform(0.2, 0.95, (n, 1)), jnp.float32)
    sh = jnp.asarray(rng.uniform(-0.5, 0.5, (n, 1, 3)), jnp.float32)
    cam = j_cameras.Camera.from_c2w(j_cameras.orbit_camera(10, 30, 2.0),
                                    0.6, 0.6)

    def loss(op):
        o = j_rasterize(means, scales, quats, op, sh, cam, 256, 256,
                        jnp.ones((3,)), capacity=256,
                        sp_mesh=j_mesh.make_sp_mesh(2))
        return jnp.sum(o.image ** 2) + jnp.sum(o.depth ** 2), o

    (_, j_out), j_grad = jax.value_and_grad(loss, has_aux=True)(opac)
    for f in ("image", "depth", "alpha"):
        ref = np.asarray(getattr(j_out, f))
        assert_close_except_cut_flips(
            ranks[0][f"sp.{f}"], ref, 1e-4 * max(1.0, float(np.abs(ref).max())),
            f, max_px_frac=5e-3)
    j_grad = np.asarray(j_grad)
    print("port sharded vs dimo_tpu sharded gradient: max abs",
          float(np.abs(g_sp - j_grad).max()), "relative L2",
          rel_l2(g_sp, j_grad))
    np.testing.assert_allclose(g_sp, j_grad, rtol=5e-3, atol=1e-2)


def test_card_worker_on_the_cpu(tmp_path):
    """`chip_smoke.py`'s two-rank phase at a small size on the CPU: the
    flagship scene cut to 2,048 Gaussians, 32 control points and a latent
    of 8, 2 motions x 1 view x 2 frames at 128^2 (2 jobs a rank), and the
    fps render at 128^2."""
    out = tmp_path / "out"
    out.mkdir()
    kw = {"device": "cpu", "shape": (2, 1, 2), "res": 128, "capacity": 256,
          "fps_size": 128, "fps_capacity": 256, "fps_rounds": 2,
          "scene": {"n_gauss": 2048, "n_cpts": 32, "latent_dim": 8}}
    check.spawn(check.card_worker, 2, (str(tmp_path / "rdv"), str(out), kw),
                SPAWN_TIMEOUT_S)
    for r in range(2):
        res = json.loads((out / f"card_rank{r}.json").read_text())
        np.testing.assert_allclose(res["loss"], res["ref_loss"], rtol=1e-5)
        np.testing.assert_allclose(res["mse"], res["ref_mse"], rtol=1e-5)
        assert max(res["grad_rel_l2"].values()) <= 1e-3, res["grad_rel_l2"]
        assert all(res["same_as_rank0"].values()) and not res["nonfinite"]
        assert res["launches"] == {"K1 ch7": 0, "K3": 0, "K2": 0, "K4": 0}
        assert res["sp_ch3_equal"] and res["sp_ch7_equal"]
        assert res["fps_full"] > 0 and res["fps_sp"] > 0


def test_train_cli_as_torchrun_starts_it(tmp_path):
    """The train CLI's body in two ranks joined from the environment
    `torchrun` sets (gloo on the CPU), data_parallel=2 on synthetic videos
    (2 motions, one job a rank), then the fps harness with
    spatial_parallel=2 on the checkpoint rank 0 wrote; both ranks end with
    the same state."""
    import socket
    save = tmp_path / "run"
    argv = ["--config", os.path.join(REPO, "configs", "train_config.yaml"),
            "train_dynamic=True", "input_folder=synthetic",
            f"save_path={save}", "ref_size=64", "num_views=3",
            "num_frames=5", "num_cpts=24", "capacity_s1=64",
            "tile_capacity=64", "iters_s1=2", "iters_s2=1", "batch_size=1",
            "num_pts_per_cpt=4", "latent_code_dim=8", "save_inter=100000",
            "W=128", "H=128"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "out"
    out.mkdir()
    check.spawn(check.cli_worker, 2, (port, str(out),
                                      {"argv": argv, "fps_size": 64}),
                SPAWN_TIMEOUT_S)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    assert all(int(r["mesh_size"]) == 2 and float(r["fps"]) > 0
               for r in ranks)
    _assert_ranks_identical(ranks, ("p.", "aux.", "mu."))
    for stage in ("s1", "s2"):
        assert (save / stage / "point_cloud.ply").exists()
    assert (save / "config.yaml").exists()
