"""Rank workers that hold the parallel paths against the unsharded ones.

Each worker is the body of one process of a group made by `spawn`
(`torch.multiprocessing`, a `file://` rendezvous, gloo): the tests run
them on the CPU and `chip_smoke.py` on the card (two ranks sharing it).
They live in the package so that a spawned process imports neither the
caller's module nor JAX. Every rank writes what it measured into
`out_dir/rank{r}.npz` (plus a JSON summary from rank 0); the caller
compares.

  * `dp_trainer_worker`: the `Trainer` at data_parallel=N against a
    Trainer without a mesh fed the same batches, each step from the same
    state: s1 steps across a densification, `finish_s1`,
    `prepare_train_s2`, s2 steps;
  * `card_worker`: on the flagship scene, one `make_train_step` step with
    a mesh against the same step without one, and the fps render sharded
    over the ranks against the unsharded one;
  * `sp_render_worker`: `rasterize(..., sp=mesh)` against the unsharded
    render, image and gradients;
  * `cli_worker`: one rank of `torchrun ... main_train_dimo_torch.py
    data_parallel=N`: the group joined from the environment torchrun
    sets, the train CLI's body, then the fps harness sharded over the
    same group.
"""
from __future__ import annotations

import copy
import json
import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dimo_tpu_torch.parallel import mesh as mesh_mod

BETA1 = 0.9        # Adam's first-moment decay (`train/optim.py`)


def spawn(fn, world: int, args: tuple, timeout_s: float) -> None:
    """Run fn(rank, world, *args) in `world` new processes and wait for
    them; a rank that fails or outlives timeout_s fails the call (every
    rank is then killed)."""
    ctx = mp.start_processes(fn, args=(world, *args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, min(5.0,
                                                deadline - time.time()))):
            if time.time() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running "
                                   f"after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def init_rank(rank: int, world: int, init_file: str, timeout_s: float,
              device: str = "cpu") -> mesh_mod.Mesh:
    """Join a gloo group of `world` ranks at file://init_file; one intra-op
    thread per rank (the ranks share the machine's cores)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return mesh_mod.make_mesh(world, device=device)


def clone_state(state):
    """A deep copy of a TrainState, its generator's position included."""
    rng, state.rng = state.rng, None
    try:
        out = copy.deepcopy(state)
    finally:
        state.rng = rng
    out.rng = torch.Generator(device=rng.device)
    out.rng.set_state(rng.get_state())
    return out


def fresh_grads(state) -> dict:
    """The gradients of the first step of a fresh optimizer, read back from
    its first moments (mu = (1 - beta1) g)."""
    return {k: (v.detach().double() / (1.0 - BETA1)).cpu().numpy()
            for k, v in state.opt.mu.items()}


def state_arrays(state, prefix: str = "") -> dict:
    """The parameters, bookkeeping and moments of a state as numpy."""
    from dimo_tpu_torch.train import optim
    out = {f"{prefix}p.{k}": v.detach().cpu().numpy()
           for k, v in optim.named_leaves(state.params).items()}
    for f in ("active", "c_active", "max_radii2d", "xyz_grad_accum", "denom"):
        out[f"{prefix}aux.{f}"] = getattr(state.aux, f).cpu().numpy()
    for k, v in state.opt.mu.items():
        out[f"{prefix}mu.{k}"] = v.cpu().numpy()
    return out


def _sync(ref, tr) -> None:
    """Make trainer ref continue from tr's state and schedule."""
    ref.state = clone_state(tr.state)
    ref.mcfg, ref.stage, ref.step = tr.mcfg, tr.stage, tr.step
    ref.tile_capacity = tr.tile_capacity
    ref.cpts_s1 = None if tr.cpts_s1 is None else tr.cpts_s1.copy()
    ref._dev_cpts = None
    ref._step_fns.clear()


def _step_both(tr, ref, log: list) -> None:
    """One step of each trainer on the same batch from the same state."""
    meta = tr._sample_meta()
    tr._pending_meta, ref._pending_meta = dict(meta), dict(meta)
    _sync(ref, tr)
    got = {}
    tr.log_fn = lambda s, st, m, trainer: got.update(dp=m)
    ref.log_fn = lambda s, st, m, trainer: got.update(ref=m)
    tr.train_step_once()
    ref.train_step_once()
    if "dp" in got:
        log.append({"stage": tr.stage, "step": tr.step,
                    **{f"{w}_{k}": float(got[w][k]) for w in ("dp", "ref")
                       for k in ("loss", "mse", "overflow", "overflow_max",
                                 "grad_norm")}})


def dp_trainer_worker(rank: int, world: int, init_file: str, out_dir: str,
                      kw: dict, timeout_s: float = 120.0) -> None:
    """Trainer at data_parallel=world vs a Trainer without a mesh.

    kw: "data" (make_synthetic_videos' keyword arguments), "opt"
    (tiny_synthetic_opt's), "s1_steps", "s2_steps", optional "start"
    (an npz of numpy params and aux to start stage 1 from, and
    "start_s2" to start stage 2 from instead of `prepare_train_s2`, with
    its cached trajectories). Writes each rank's states after the first
    s1 step, the last s1 step, prepare_train_s2 and the s2 steps; rank 0
    also the reference's gradients of the first s1 and s2 steps and the
    per-step losses."""
    from dimo_tpu_torch.io.synthetic import make_synthetic_videos
    from dimo_tpu_torch.presets import tiny_synthetic_opt
    from dimo_tpu_torch.train.loop import Trainer
    mesh = init_rank(rank, world, init_file, timeout_s)
    data = make_synthetic_videos(device="cpu", **kw["data"])
    opt = tiny_synthetic_opt(data_parallel=world, **kw["opt"])
    tr = Trainer(opt, *data, device="cpu")
    assert tr.mesh is not None and tr.mesh.size == world
    ref_opt = tiny_synthetic_opt(data_parallel=1, **{
        **kw["opt"], "save_path": os.path.join(out_dir, f"ref{rank}")})
    ref = Trainer(ref_opt, *data, device="cpu")
    assert ref.mesh is None
    if kw.get("start"):
        _load_start(tr, kw["start"])
    tr.prepare_train_s1()
    ref.prepare_train_s1()
    log, arrays = [], {}
    for i in range(kw["s1_steps"]):
        _step_both(tr, ref, log)
        if i == 0:
            arrays.update(state_arrays(tr.state, "s1first."))
            arrays.update({f"s1first.ref_g.{k}": v for k, v in
                           fresh_grads(ref.state).items()})
            arrays.update({f"s1first.g.{k}": v for k, v in
                           fresh_grads(tr.state).items()})
    arrays.update(state_arrays(tr.state, "s1last."))
    tr.finish_s1()
    if kw.get("start_s2"):
        _load_start(tr, kw["start_s2"], stage="s2")
    else:
        tr.prepare_train_s2()
    arrays.update(state_arrays(tr.state, "s2prep."))
    arrays["s2prep.cpts_s1"] = tr.cpts_s1
    for i in range(kw["s2_steps"]):
        _step_both(tr, ref, log)
        if i == 0:
            arrays.update({f"s2first.ref_g.{k}": v for k, v in
                           fresh_grads(ref.state).items()})
            arrays.update({f"s2first.g.{k}": v for k, v in
                           fresh_grads(tr.state).items()})
    arrays.update(state_arrays(tr.state, "s2last."))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    if rank == 0:
        with open(os.path.join(out_dir, "log.json"), "w") as f:
            json.dump({"steps": log, "capacity": tr.mcfg.capacity,
                       "tile_capacity": tr.tile_capacity}, f)
    mesh_mod.barrier(mesh)
    dist.destroy_process_group()


def _load_start(tr, path: str, stage: str = "s1") -> None:
    """Start tr (stage 1, or stage 2 with its cached trajectories) from
    numpy params and aux saved by `save_start`."""
    import dataclasses
    from dimo_tpu_torch.io.convert import params_from_numpy
    from dimo_tpu_torch.train.step import init_state
    with np.load(path, allow_pickle=True) as z:
        tree = z["tree"].item()
        cpts = z["cpts_s1"] if "cpts_s1" in z else None
    params, aux = params_from_numpy(tree, device=tr.device)
    tr.mcfg = dataclasses.replace(tr.mcfg, capacity=params.xyz.shape[0],
                                  cpt_capacity=params.c_xyz.shape[0])
    tr.state = init_state(params, aux, step=0, seed=tr.seed)
    if stage == "s2":
        tr.stage, tr.step, tr.cpts_s1 = "s2", 0, cpts
        tr._dev_cpts = None
    tr._step_fns.clear()


def save_start(path: str, tree: dict, cpts_s1=None) -> None:
    """Write numpy params and aux (`io/convert.py::params_from_numpy`'s
    input) for `_load_start`."""
    extra = {} if cpts_s1 is None else {"cpts_s1": cpts_s1}
    np.savez(path, tree=np.array(tree, dtype=object), **extra)


def card_worker(rank: int, world: int, init_file: str, out_dir: str,
                kw: dict, timeout_s: float = 300.0) -> None:
    """On the flagship scene (`scenes.flagship_scene`, TimeNet's output
    layers seeded by `scenes.move_timenet`), ranks sharing one
    device: one `make_train_step` step with a mesh of `world` ranks against
    the same step without one from one state, then the `run_test_fps`
    render sharded over the ranks against the unsharded render.

    kw: "device", "shape" (motions, views, frames), "res", "capacity",
    "fps_size", "fps_capacity", "fps_rounds", optional "scene"
    (`flagship_scene`'s keyword arguments, to cut it). The batch is
    `scenes.train_batch`, `bench_train_torch.py`'s (seeded cameras, random
    GT, zero guidance), cut by `shard_batch`. Every rank also computes the
    unsharded step (its ARAP draws come from a copy of the same
    generator), once to warm up and once timed while the other ranks wait;
    the data-parallel step is taken twice, the first counted and compared,
    the second timed. Each
    rank checks its parameters against rank 0's bit for bit and writes
    out_dir/card_rank{r}.json."""
    from dimo_tpu_torch.models.renderer import find_knn, render
    from dimo_tpu_torch.ops import smallgather as sg
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    from dimo_tpu_torch.scenes import (flagship_scene, move_timenet,
                                       train_batch)
    from dimo_tpu_torch.train import optim
    from dimo_tpu_torch.train.step import (LossConfig, init_state,
                                           make_train_step)
    dev = torch.device(kw["device"])
    mesh = init_rank(rank, world, init_file, timeout_s, device=dev)
    cfg, params, aux, cam = flagship_scene(device=dev, **kw.get("scene", {}))
    move_timenet(params, 1)    # the control points move: ARAP has a gradient
    state = init_state(params, aux, step=0)
    shape = tuple(kw["shape"])
    batch = train_batch(params, shape, kw["res"], dev)
    lcfg = LossConfig()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, *a):
        sync()
        t0 = time.perf_counter()
        r = fn(*a)
        sync()
        return r, time.perf_counter() - t0

    ref_fn = make_train_step(cfg, lcfg, "s2", kw["res"], kw["res"], *shape,
                             capacity=kw["capacity"], use_guidance=True)
    warm_state, _ = ref_fn(clone_state(state), batch)       # warm-up
    for r in range(world):       # each rank times its step while the
        mesh_mod.barrier(mesh)   # others wait, so it has the card alone
        if r == rank:
            (ref_state, ref_m), ref_s = timed(ref_fn, clone_state(state),
                                              batch)
    dp_fn = make_train_step(cfg, lcfg, "s2", kw["res"], kw["res"], *shape,
                            capacity=kw["capacity"], use_guidance=True,
                            mesh=mesh)
    local = mesh_mod.shard_batch(batch, mesh)
    cs.launches = dict.fromkeys(cs.launches, 0)
    sg.launches = sg.bwd_launches = 0
    mesh_mod.barrier(mesh)
    state, m = dp_fn(state, local)
    sync()
    launches = {"K1 ch7": cs.launches["ch7"], "K3": cs.launches["bwd"],
                "K2": sg.launches, "K4": sg.bwd_launches}
    g, g_ref = fresh_grads(state), fresh_grads(ref_state)
    same = {}
    for k, v in optim.named_leaves(state.params).items():
        r0 = v.detach().clone()
        mesh_mod.replicate([r0], mesh, src=0)
        same[k] = bool(torch.equal(r0, v.detach()))
    out = {"loss": float(m["loss"]), "ref_loss": float(ref_m["loss"]),
           "mse": float(m["mse"]), "ref_mse": float(ref_m["mse"]),
           "launches": launches, "same_as_rank0": same,
           "nonfinite": int(m["nonfinite_grad"]),
           "grad_rel_l2": {k: float(np.linalg.norm(g[k] - g_ref[k])
                                    / max(np.linalg.norm(g_ref[k]), 1e-30))
                           for k in g}}
    # the unsharded step's own spread: two runs from one state (0 on the
    # card since the scatter-adds sum in a fixed order; kept as a check of
    # the comparison's floor)
    g_warm = fresh_grads(warm_state)
    out["ref_spread_rel_l2"] = {
        k: float(np.linalg.norm(g_warm[k] - g_ref[k])
                 / max(np.linalg.norm(g_ref[k]), 1e-30)) for k in g}
    mesh_mod.barrier(mesh)
    _, out["dp_step_s"] = timed(dp_fn, state, local)
    out["ref_step_s"] = ref_s
    del state, ref_state, warm_state, batch, local

    # the fps harness's render (ch3, KNN once) and the 7-channel render,
    # sharded over the ranks against unsharded
    sp = mesh_mod.make_sp_mesh(world, device=dev)
    size, cap = kw["fps_size"], kw["fps_capacity"]
    bg = torch.ones(3, device=dev)
    with torch.no_grad():
        knn = find_knn(params, aux)

        def frame(ch, mesh_):
            return render(cfg, params, aux, cam, 0.0, "s2", 0, size, size,
                          bg, knn_cache=knn, capacity=cap, channels=ch,
                          sp=mesh_)["image"]

        for ch in (3, 7):
            full, shard = frame(ch, None), frame(ch, sp)
            out[f"sp_ch{ch}_equal"] = bool(torch.equal(full, shard))
            out[f"sp_ch{ch}_max_err"] = float((full - shard).abs().max())
        rounds = kw["fps_rounds"]
        for name, mesh_ in (("fps_full", None), ("fps_sp", sp)):
            mesh_mod.barrier(sp)
            cs.launches = dict.fromkeys(cs.launches, 0)
            _, sec = timed(lambda: [frame(3, mesh_) for _ in range(rounds)])
            out[name] = rounds / sec
            out[f"{name}_k1_ch3"] = cs.launches["ch3"]
    with open(os.path.join(out_dir, f"card_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    mesh_mod.barrier(mesh)
    dist.destroy_process_group()


def sp_scene(device, n: int = 300, seed: int = 7) -> tuple:
    """`tests/test_multichip.py`'s spatial-sharding scene: n Gaussians in a
    unit box, one orbit camera, white background."""
    from dimo_tpu_torch.utils import cameras
    rng = np.random.RandomState(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    means = t(rng.uniform(-0.5, 0.5, (n, 3)))
    scales = t(np.exp(rng.uniform(-4.0, -2.5, (n, 3))))
    quats = t(rng.randn(n, 4))
    opac = t(rng.uniform(0.2, 0.95, (n, 1)))
    sh = t(rng.uniform(-0.5, 0.5, (n, 1, 3)))
    cam = cameras.Camera.from_c2w(cameras.orbit_camera(10, 30, 2.0), 0.6, 0.6)
    return means, scales, quats, opac, sh, cam, torch.ones(3, device=device)


def sp_render_worker(rank: int, world: int, init_file: str, out_dir: str,
                     kw: dict, timeout_s: float = 120.0) -> None:
    """`rasterize(..., sp=mesh)` against the unsharded render on
    `sp_scene`: image, depth and the loss sum(image^2) + sum(depth^2) with
    its gradient in the opacities. kw: "device", "size", "capacity".
    Writes both renders and gradients (rank r: rank{r}.npz)."""
    from dimo_tpu_torch.ops.rasterizer import rasterize
    dev = torch.device(kw["device"])
    init_rank(rank, world, init_file, timeout_s)
    sp = mesh_mod.make_sp_mesh(world, device=dev)
    means, scales, quats, opac, sh, cam, bg = sp_scene(dev)
    size = kw["size"]
    out = {}
    for name, mesh in (("full", None), ("sp", sp)):
        op = opac.clone().requires_grad_(True)
        r = rasterize(means, scales, quats, op, sh, cam, size, size, bg,
                      capacity=kw["capacity"], sp=mesh)
        loss = torch.sum(r.image ** 2) + torch.sum(r.depth ** 2)
        loss.backward()
        out.update({f"{name}.image": r.image.detach().cpu().numpy(),
                    f"{name}.depth": r.depth.detach().cpu().numpy(),
                    f"{name}.alpha": r.alpha.detach().cpu().numpy(),
                    f"{name}.loss": loss.item(),
                    f"{name}.grad": op.grad.cpu().numpy()})
    with torch.no_grad():
        for name, mesh in (("full3", None), ("sp3", sp)):
            r = rasterize(means, scales, quats, opac, sh, cam, size, size,
                          bg, capacity=kw["capacity"], channels=3, sp=mesh)
            out[f"{name}.image"] = r.image.cpu().numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    mesh_mod.barrier(sp)
    dist.destroy_process_group()


def cli_worker(rank: int, world: int, port: int, out_dir: str, kw: dict,
               timeout_s: float = 120.0) -> None:
    """One rank as `torchrun --nproc_per_node world` starts it (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT in the environment):
    `cli.train_main(kw["argv"] + ["data_parallel=world"])` on the CPU, then
    `run_test_fps` with spatial_parallel=world at a small size. Writes the
    rank's final state and the harness's frames/s."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from dimo_tpu_torch import cli, test_modes
    mesh_mod.init_from_env(timeout_s=timeout_s)   # what run_train does
    tr = cli.train_main(kw["argv"] + [f"data_parallel={world}"],
                        device="cpu")
    out = state_arrays(tr.state)
    out["mesh_size"] = tr.mesh.size
    tr.opt["spatial_parallel"] = world
    out["fps"] = test_modes.run_test_fps(tr, rounds=2, size=kw["fps_size"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    mesh_mod.barrier(tr.mesh)
    dist.destroy_process_group()
