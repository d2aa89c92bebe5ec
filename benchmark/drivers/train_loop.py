"""Training as a user runs it: `Trainer.train_step_once` in a loop.

Set-up makes the inputs from the seed (the scene, LPIPS weights, the
dataset in host memory, the stage-1 guidance), builds one Trainer that
holds them at the configuration's step and settled strip capacity, and
drives it through its first steps, which warm up every shape the window
uses. The reference follows those first steps afterwards from the same
inputs. The window then runs steps for the run's seconds and ends in a
synchronize. With tracing on, the host's time in `sample_batch` and the
step's own segments (`mark`) are recorded in the window, and the
profiler traces the device alone over the second and third of the first
steps, whose work the reference counts on its own strip lists; their
time a step on the host's clock is reported beside the window's.
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from harness import checks, clock, inputs
from harness import trace as trace_mod
from reference import batches as ref_batches
from reference import model as ref_model
from reference import optim as ref_optim
from reference import step as ref_step
from reference.composite import count_pairs
from reference.lpips import LPIPS as RefLPIPS
from reference.render import render as ref_render
from work import compositor, knn as knn_work, timenet as tn_work, vgg16

FIRST_STEPS = 3         # the steps the reference follows
PROFILED = (2, 3)       # of those, the ones the profiler traces (the rest)


def trainer_opt(cfg: dict, seed: int, save_path: str):
    from dimo_tpu_torch.io.config import Config
    opt = dict(cfg)
    opt.update(seed=inputs.sub_seed(seed, "trainer"), save_path=save_path,
               data_parallel=1)
    return Config(opt)


def setup(cfg: dict, traffic: dict, seed: int, device, save_path: str,
          trace: bool, t_start: float) -> dict:
    from dimo_tpu_torch.io.convert import lpips_params_from_numpy, \
        params_from_numpy
    from dimo_tpu_torch.models import gaussians as G
    from dimo_tpu_torch.models.lpips import LPIPS
    from dimo_tpu_torch.train.loop import Trainer
    from dimo_tpu_torch.train.step import init_state

    stage = cfg["stage"]
    opt = trainer_opt(cfg, seed, save_path)
    scene = inputs.scene(cfg, seed, device)
    lp = inputs.lpips_numpy(seed, device)
    images, masks = inputs.dataset(cfg, seed, device)
    n_m, n_v = int(cfg["scene"]["num_motions"]), int(opt.num_views)
    meta = {"input_videos": [f"motion_{i:02d}" for i in range(n_m)],
            "azimuths": [360.0 / n_v * v for v in range(n_v)]}
    guid = (inputs.guidance(cfg, scene["c_xyz"], seed, device)
            if stage == "s2" else None)

    tr = Trainer(opt, images, masks, meta, device=device)
    params, aux = params_from_numpy(scene, device)
    tr.mcfg = G.ModelConfig(
        sh_degree=int(opt.sh_degree), latent_dim=int(opt.latent_code_dim),
        num_latents=n_m, vae=False, capacity=int(scene["xyz"].shape[0]),
        cpt_capacity=int(scene["c_xyz"].shape[0]),
        percent_dense=opt.percent_dense)
    start = int(cfg["start_step"])
    tr.state = init_state(params, aux, step=start, seed=tr.seed)
    tr.stage, tr.step = stage, start
    tr.tile_capacity = int(cfg["settled_tile_capacity"])
    tr.cpts_s1 = guid
    lpips_fn = (LPIPS(lpips_params_from_numpy(lp, device)).to(device)
                if traffic.get("lpips", True) else None)

    ck = clock.Clock(device)
    stretch = trace_mod.Stretch(ck, tail="trainer")
    rec = {"losses": [], "batches": [], "batch_s": [], "marks": [],
           "capacity": []}
    tr.log_fn = lambda stg, step, metrics, trainer=None: (
        rec["losses"].append(metrics["loss"]),
        rec["capacity"].append(trainer.tile_capacity))
    sample = tr.sample_batch

    def sample_batch():
        stretch.note("trainer")
        t = time.perf_counter()
        out = sample()
        if trace:
            rec["batch_s"].append(time.perf_counter() - t)
        stretch.note("sample_batch")
        if len(rec["batches"]) < FIRST_STEPS:
            b = out[0]
            rec["batches"].append({
                "latent_idx": list(b["latent_idx"]), "times": list(b["times"]),
                "mse_w": list(b["mse_w"]),
                "world_view": [c.world_view for c in b["camera"]],
                "gt_image": b["gt_image"], "gt_mask": b["gt_mask"],
                "guidance": b.get("guidance")})
        return out
    tr.sample_batch = sample_batch
    get_step_fn = tr.get_step_fn

    def marked_step_fn(*a, **k):
        fn = get_step_fn(*a, **k)

        def step(state, batch):
            m = [("start", ck.mark())]
            stretch.note("trainer", m[0][1])

            def mark(name):
                m.append((name, ck.mark()))
                stretch.note(name, m[-1][1])
            out = fn(state, batch, mark=mark)
            rec["marks"].append(m)
            return out
        return step
    if trace:
        tr.get_step_fn = marked_step_fn

    tr.train_step_once(lpips_fn)
    prog = {"grad": checks.norms({n: m / (1 - ref_optim.BETA1)
                                  for n, m in tr.state.opt.mu.items()})}
    ck.sync()
    t = time.perf_counter()
    with (stretch.profile() if trace else contextlib.nullcontext()):
        for _ in PROFILED:
            tr.train_step_once(lpips_fn)
    ck.sync()
    rec["profiled_s"] = time.perf_counter() - t
    from dimo_tpu_torch.train import optim
    leaves = optim.named_leaves(tr.state.params)
    p0 = ref_model.from_numpy(scene, device)
    prog["change"] = checks.norms(
        {n: leaves[n].detach() - v.detach()
         for n, v in ref_optim.named_leaves(p0).items()})
    del p0
    ck.sync()
    return {"tr": tr, "lpips_fn": lpips_fn, "lpips_on": lpips_fn is not None,
            "rec": rec, "prog": prog,
            "clock": ck, "stretch": stretch if trace else None,
            "scene": scene, "lpips": lp,
            "images": images, "masks": masks, "guidance": guid,
            "meta": meta, "opt": opt,
            "setup_s": time.perf_counter() - t_start}


def window(s: dict, seconds: float, device) -> dict:
    tr, rec, ck = s["tr"], s["rec"], s["clock"]
    first = len(rec["marks"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ck.sync()
    t0 = time.perf_counter()
    stamps = [t0]
    while True:
        tr.train_step_once(s["lpips_fn"])
        stamps.append(time.perf_counter())
        if stamps[-1] - t0 >= seconds:
            break
    n = len(stamps) - 1
    ck.sync()
    t1 = time.perf_counter()
    segs = []
    for m in rec["marks"][first:]:
        t = dict(m)
        names = [x for x, _ in m]
        segs.append({b: ck.seconds(t[a], t[b])
                     for a, b in zip(names[:-1], names[1:])})
    return {"steps": n, "window_s": t1 - t0,
            "step_s": [b - a for a, b in zip(stamps[:-1], stamps[1:])],
            "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
            "batch_s": rec["batch_s"][-n:] if rec["batch_s"] else [],
            "segments": segs,
            "capacity": rec["capacity"][FIRST_STEPS:]}


def follow(s: dict, cfg: dict, device, count_work: bool, tf32: bool = False,
           fault: str | None = None) -> dict:
    """The reference's first steps from the run's inputs: the losses, the
    first gradient's and the change's leaf norms, its own batches, and
    with `count_work` the compositor's pairs of the profiled steps."""
    from reference.general import set_tf32
    set_tf32(tf32)
    opt, stage = s["opt"], cfg["stage"]
    first = int(cfg["start_step"]) + 1
    res = 128 if first < 300 else (256 if first < 450 else 512)
    lcfg = ref_step.loss_config(opt, stage)
    params = ref_model.from_numpy(s["scene"], device)
    p0 = {k: v.detach().clone()
          for k, v in ref_optim.named_leaves(params).items()}
    adam = ref_optim.init(ref_optim.named_leaves(params))
    net = (RefLPIPS({k: torch.as_tensor(v) for k, v in s["lpips"].items()},
                    tf32=tf32).to(device)
           if s["lpips_on"] else None)
    gen = torch.Generator().manual_seed(int(opt.seed))
    bs = int(opt.batch_size)
    rows = ref_batches.draw(int(opt.seed), FIRST_STEPS,
                            int(cfg["scene"]["num_motions"]),
                            int(opt.num_views), int(opt.num_frames), bs)
    per = min(bs, int(opt.num_views)) * min(bs, int(opt.num_frames))
    out = {"losses": [], "rows": rows, "work": []}
    cap = int(cfg["settled_tile_capacity"])
    for k in range(1, FIRST_STEPS + 1):
        b = ref_batches.batch(rows[k - 1], opt, s["meta"]["azimuths"],
                              s["images"], s["masks"], s["guidance"])
        if fault == "half_batch":
            keep = len(b["times"]) // 2
            b = {key: (v[:keep] if isinstance(v, (list, np.ndarray)) else v)
                 for key, v in b.items()}
        if count_work and k in PROFILED:
            out["work"] += render_work(params, b, stage, res, cap, device)
        adam, loss, _, grads = ref_step.train_step(
            params, adam, int(cfg["start_step"]) + k, b, lcfg, stage, res,
            cap, net, per, gen)
        out["losses"].append(float(loss))
        if k == 1:
            out["grad"] = checks.norms(grads)
    out["change"] = checks.norms(
        {k: v.detach() - p0[k]
         for k, v in ref_optim.named_leaves(params).items()})
    set_tf32(False)
    return out


@torch.no_grad()
def render_work(params, b: dict, stage: str, res: int, cap: int,
                device) -> list:
    """[(K3 operations, bytes)] of each render of a batch, on the
    reference's own lists and table."""
    from reference.render import find_knn
    knn = find_knn(params) if stage >= "s2" else None
    bg = torch.ones(3, device=device)
    out = []
    for i in range(len(b["times"])):
        o = ref_render(params, b["camera"][i], float(b["times"][i]), stage,
                       int(b["latent_idx"][i]), res, res, bg, cap, knn=knn)
        w = count_pairs(o["table"], o["lists"].idx, o["lists"].count,
                        *o["pad"])
        out.append({"k1": compositor.k1(w["pairs"], w["live"], w["entries"],
                                        w["table_rows"], w["strips"],
                                        *o["pad"]),
                    "k3": compositor.k3(w["pairs"], w["live"], w["entries"],
                                        w["slots"], w["strips"], *o["pad"])})
    return out


def batch_mismatches(rec: dict, ref_rows: list, s: dict, opt) -> int:
    """Rows of the first steps' batches that differ from the reference's
    draw: motion, time, MSE weight, camera, and the frame and mask
    bytes."""
    bad = 0
    for got, rows in zip(rec["batches"], ref_rows):
        want = ref_batches.batch(rows, opt, s["meta"]["azimuths"],
                                 s["images"], s["masks"], s["guidance"])
        gi = torch.as_tensor(got["gt_image"]).cpu().numpy()
        gm = torch.as_tensor(got["gt_mask"]).cpu().numpy()
        for i in range(len(rows)):
            same = (int(got["latent_idx"][i]) == want["latent_idx"][i]
                    and np.float32(got["times"][i]) == np.float32(
                        want["times"][i])
                    and float(got["mse_w"][i]) == want["mse_w"][i]
                    and np.array_equal(got["world_view"][i],
                                       want["camera"][i].world_view)
                    and np.array_equal(gi[i], want["gt_image"][i])
                    and np.array_equal(gm[i], want["gt_mask"][i]))
            if want.get("guidance") is not None:
                same = same and np.array_equal(
                    torch.as_tensor(got["guidance"][i]).cpu().numpy(),
                    want["guidance"][i])
            bad += not same
    bad += abs(len(rec["batches"]) - len(ref_rows))
    return bad


def step_images(cfg: dict, opt) -> tuple:
    """(motions, renders, resolution) of a train step after the first."""
    bs = int(opt.batch_size)
    n_m = min(2 * bs, int(cfg["scene"]["num_motions"]))
    b = n_m * min(bs, int(opt.num_views)) * min(bs, int(opt.num_frames))
    first = int(cfg["start_step"]) + 1
    return n_m, b, 128 if first < 300 else (256 if first < 450 else 512)


def step_flops(cfg: dict, opt, work: list, lpips_on: bool) -> float:
    """float32 operations of one train step: LPIPS, the compositor both
    ways, TimeNet forward and backward (renders and ARAP), the KNN."""
    n_m, b, res = step_images(cfg, opt)
    n_g = int(cfg["scene"]["num_gaussians"])
    n_c = int(cfg["num_cpts"]) if cfg["stage"] == "s2" else n_g
    lat = int(opt.latent_code_dim)
    comp = sum(w["k1"][0] + w["k3"][0] for w in work) / max(1, len(work)) * b
    tn = tn_work.flops(b * n_c + 8 * n_m * n_c, lat, backward=True)
    kn = knn_work.flops(n_g, int(cfg["num_cpts"])) \
        if cfg["stage"] == "s2" else 0.0
    lp = vgg16.lpips_step_flops(b, res, res) if lpips_on else 0.0
    return lp + comp + tn + kn


def release(s: dict, device) -> None:
    """Free the program's state before the reference runs."""
    tr = s.pop("tr")
    packer = getattr(tr, "_packer", None)
    if packer is not None:
        packer.close()
    del tr
    s["lpips_fn"] = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        save_path: str, t_start: float) -> dict:
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    s = setup(cfg, traffic, seed, device, save_path, trace, t_start)
    setup_peak = (torch.cuda.max_memory_allocated()
                  if torch.device(device).type == "cuda" else None)
    win = window(s, seconds, device)
    record = {"device": torch.device(device).type, "setup_s": s["setup_s"],
              "train": win, "trace": None,
              "setup_step_ms": 1e3 * s["rec"]["profiled_s"] / len(PROFILED),
              "capacity_moved": sum(c != int(cfg["settled_tile_capacity"])
                                    for c in win["capacity"])}
    if s["stretch"] is not None:
        record["trace"] = trace_mod.summary(s["stretch"])
    if record["trace"] is not None:
        record["trace"]["steps"] = len(PROFILED)
        record["trace"]["step_ms"] = (1e3 * record["trace"]["host_s"]
                                      / len(PROFILED))
    peak = max(setup_peak, win["peak_bytes"]) if setup_peak else None
    rec, prog, opt = s["rec"], s["prog"], s["opt"]
    prog["losses"] = [float(x) for x in rec["losses"][:FIRST_STEPS]]
    release(s, device)
    t_ref = time.perf_counter()
    ref = follow(s, cfg, device, count_work=trace)
    record["reference_s"] = time.perf_counter() - t_ref
    numbers = checks.train_numbers(prog, ref)
    exact = {"batch_mismatch": batch_mismatches(rec, ref["rows"], s, opt)}
    correct, rows = checks.judge(numbers, limits, exact)
    if ref["work"]:
        record["work"] = {"k3": [w["k3"] for w in ref["work"]],
                          "step_flops": step_flops(cfg, opt, ref["work"],
                                                   s["lpips_on"])}
        if s["lpips_on"]:
            # LPIPS's forward, both towers, over the profiled steps: two
            # thirds of a step's LPIPS operations (no input gradient)
            _, b, res = step_images(cfg, opt)
            record["work"]["lpips_flops"] = len(PROFILED) * 2.0 / 3.0 \
                * vgg16.lpips_step_flops(b, res, res)
    return {"record": record, "correct": correct, "checks": rows,
            "numbers": {k: v for k, (v, _) in numbers.items()},
            "attempted": win["steps"], "failed": 0, "peak_bytes": peak}


def readings(cell: dict, seed: int, device, save_path: str,
             variants=("program", "control", "half_batch")) -> dict:
    """{variant: {number: value}} against the float32 reference on one
    seed, with no measured window: the program's first steps, the
    reference computed with TF32 on in the program's place (the control),
    and the reference with half of each batch left out (a fault)."""
    cfg, traffic = cell["config"], cell["traffic"]
    s = setup(cfg, traffic, seed, device, save_path, False,
              time.perf_counter())
    prog = s["prog"]
    prog["losses"] = [float(x) for x in s["rec"]["losses"][:FIRST_STEPS]]
    release(s, device)
    ref = follow(s, cfg, device, count_work=False)
    runs = {"program": prog,
            "control": lambda: follow(s, cfg, device, False, tf32=True),
            "half_batch": lambda: follow(s, cfg, device, False,
                                         fault="half_batch")}
    out = {"losses": {"reference": ref["losses"]}}
    for v in variants:
        got = runs[v] if v == "program" else runs[v]()
        out["losses"][v] = got["losses"]
        out[v] = {k: x for k, (x, _) in
                  checks.train_numbers(got, ref).items()}
    return out
