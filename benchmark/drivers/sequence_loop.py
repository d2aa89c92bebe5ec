"""Serving through the default test mode: `test_modes.render_sequence`
in a closed loop, one client.

Set-up makes the scene from the seed, builds a Trainer at the
configuration's test keys (W x H, num_frames, tile_capacity, white
background) that holds it as its s2 state, and renders one sequence from
each camera kind to warm up. Each request of the window is one sequence
of a motion drawn from the seed; a frame counts when its uint8 image is
on the host. A frame's time is the interval from the previous frame's
delivery to its own, so the intervals tile the window, and a sequence's
KNN falls in its first frame. One frame of each sequence, drawn from the
seed, is kept, and after the window the reference renders a sample of
them, drawn from the seed, from the same inputs. With tracing on, one
more sequence after the window is profiled, and the reference counts
its compositor work on its own strip lists.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import checks, clock, inputs
from harness import trace as trace_mod
from reference import batches as ref_batches
from reference import model as ref_model
from reference.composite import count_pairs
from reference.render import find_knn, render as ref_render
from work import compositor, knn as knn_work, timenet as tn_work


def setup(cfg: dict, traffic: dict, seed: int, device, save_path: str,
          t_start: float) -> dict:
    from dimo_tpu_torch import test_modes
    from dimo_tpu_torch.io.config import Config
    from dimo_tpu_torch.io.convert import params_from_numpy
    from dimo_tpu_torch.models import gaussians as G
    from dimo_tpu_torch.train.loop import Trainer
    from dimo_tpu_torch.train.step import init_state

    n_m = int(cfg["scene"]["num_motions"])
    opt = Config(dict(cfg, save_path=save_path, data_parallel=1,
                      seed=inputs.sub_seed(seed, "trainer")))
    scene = inputs.scene(cfg, seed, device)
    tiny = np.zeros((n_m, 1, 1, 8, 8, 3), np.uint8)
    meta = {"input_videos": [f"motion_{i:02d}" for i in range(n_m)],
            "azimuths": [0.0]}
    tr = Trainer(opt, tiny, tiny[..., 0], meta, device=device)
    tr.num_frames = int(cfg["num_frames"])
    params, aux = params_from_numpy(scene, device)
    tr.mcfg = G.ModelConfig(
        sh_degree=int(opt.sh_degree), latent_dim=int(opt.latent_code_dim),
        num_latents=n_m, vae=False, capacity=int(scene["xyz"].shape[0]),
        cpt_capacity=int(scene["c_xyz"].shape[0]))
    tr.state, tr.stage = init_state(params, aux), "s2"
    stamps = []
    inner = test_modes._render_fn(tr, "s2", int(opt.W), int(opt.H))

    def render_fn(*a, **k):
        stamps.append(time.perf_counter())
        return inner(*a, **k)
    reqs = inputs.requests(int(traffic["requests"]), n_m, seed)
    for m, cam in reqs[:int(traffic["warmup_requests"])]:
        test_modes.render_sequence(tr, m, "s2", cam, render_fn=render_fn)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"tr": tr, "scene": scene, "opt": opt, "stamps": stamps,
            "render_fn": render_fn, "requests": reqs,
            "setup_s": time.perf_counter() - t_start}


def window(s: dict, traffic: dict, seconds: float, seed: int) -> dict:
    from dimo_tpu_torch import test_modes
    tr, stamps = s["tr"], s["stamps"]
    n_f = tr.num_frames
    pick = np.random.RandomState(inputs.sub_seed(seed, "kept")).randint(
        0, n_f, len(s["requests"]))
    reqs = s["requests"][int(traffic["warmup_requests"]):]
    kept, intervals = [], []
    t0 = last = time.perf_counter()
    n = 0
    for i, (m, cam) in enumerate(reqs):
        del stamps[:]
        frames = test_modes.render_sequence(tr, m, "s2", cam,
                                            render_fn=s["render_fn"])
        done = stamps[1:] + [time.perf_counter()]
        for t in done:
            intervals.append(t - last)
            last = t
        kept.append((m, cam, int(pick[i]), frames[pick[i]]))
        n += len(frames)
        if last - t0 >= seconds:
            break
    return {"frames": n, "sequences": len(kept), "window_s": last - t0,
            "intervals": intervals, "kept": kept}


def ref_frames(scene: dict, opt, jobs: list, device, tf32: bool = False,
               work: bool = False, fault: str | None = None) -> tuple:
    """The reference's uint8 frames of `jobs` [(motion, camera, frame)],
    and with `work` the compositor's work of each, on its own lists;
    `fault` "next_frame" renders each job's next frame in its place."""
    from reference.general import set_tf32
    set_tf32(tf32)
    params = ref_model.from_numpy(scene, device)
    w, h, n_f = int(opt.W), int(opt.H), int(opt.num_frames)
    bg = torch.ones(3, device=device)
    frames, counted = [], []
    with torch.no_grad():
        knn = find_knn(params)
        for m, cam, f in jobs:
            if fault == "next_frame":
                f = (f + 1) % n_f
            azi = opt.test_azi if cam == "fixed" else 360 / n_f * f
            o = ref_render(params, ref_batches.camera(azi, opt), f / n_f,
                           "s2", m, w, h, bg, int(opt.tile_capacity),
                           knn=knn)
            img = o["image"].cpu().numpy().transpose(1, 2, 0)
            frames.append((img.clip(0, 1) * 255).astype(np.uint8))
            if work:
                p = count_pairs(o["table"], o["lists"].idx, o["lists"].count,
                                *o["pad"])
                counted.append(compositor.k1(p["pairs"], p["live"],
                                             p["entries"], p["table_rows"],
                                             p["strips"], *o["pad"]))
    set_tf32(False)
    return frames, counted


def frame_flops(cfg: dict, opt, k1_work: list) -> float:
    """float32 operations of one served frame: the compositor, TimeNet on
    the control points, and the sequence's KNN shared by its frames."""
    n_f = int(opt.num_frames)
    comp = sum(w[0] for w in k1_work) / max(1, len(k1_work))
    return (comp + tn_work.flops(int(cfg["num_cpts"]),
                                 int(opt.latent_code_dim), backward=False)
            + knn_work.flops(int(cfg["scene"]["num_gaussians"]),
                             int(cfg["num_cpts"])) / n_f)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        save_path: str, t_start: float) -> dict:
    from dimo_tpu_torch import test_modes
    cfg, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    cuda = torch.device(device).type == "cuda"
    s = setup(cfg, traffic, seed, device, save_path, t_start)
    win = window(s, traffic, seconds, seed)
    record = {"device": torch.device(device).type, "setup_s": s["setup_s"],
              "serve": win, "trace": None}
    profiled = []
    if trace:
        m, cam = s["requests"][-1]
        st = trace_mod.Stretch(clock.Clock(device), tail="render_sequence")
        with st.profile():
            test_modes.render_sequence(s["tr"], m, "s2", cam,
                                       render_fn=s["render_fn"])
        record["trace"] = trace_mod.summary(st)
        profiled = [(m, cam, f) for f in range(int(s["opt"].num_frames))]
    peak = torch.cuda.max_memory_allocated() if cuda else None
    kept = win.pop("kept")
    del s["tr"]
    if cuda:
        torch.cuda.empty_cache()
    rng = np.random.RandomState(inputs.sub_seed(seed, "checked"))
    sel = sorted(rng.choice(len(kept), min(len(kept),
                                           int(traffic["checked_frames"])),
                            replace=False))
    jobs = [kept[i][:3] for i in sel]
    t_ref = time.perf_counter()
    want, _ = ref_frames(s["scene"], s["opt"], jobs, device)
    record["reference_s"] = time.perf_counter() - t_ref
    numbers = checks.frame_numbers([kept[i][3] for i in sel], want)
    correct, rows = checks.judge(numbers, limits)
    if profiled:
        _, k1 = ref_frames(s["scene"], s["opt"], profiled, device, work=True)
        record["work"] = {"k1": k1,
                          "frame_flops": frame_flops(cfg, s["opt"], k1)}
    return {"record": record, "correct": correct, "checks": rows,
            "numbers": {k: v for k, (v, _) in numbers.items()},
            "attempted": win["frames"], "failed": 0, "peak_bytes": peak}


def readings(cell: dict, seed: int, device, save_path: str,
             variants=("program", "control", "next_frame"),
             seconds: float = 8.0) -> dict:
    """{variant: {number: value}} against the float32 reference on one
    seed: the frames a short window of the program delivered, the
    reference computed with TF32 on in the program's place (the control)
    and the reference rendering each frame's successor (a fault), over
    the same sample of frames."""
    cfg, traffic = cell["config"], cell["traffic"]
    s = setup(cfg, traffic, seed, device, save_path, time.perf_counter())
    win = window(s, traffic, seconds, seed)
    kept = win.pop("kept")
    del s["tr"]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.RandomState(inputs.sub_seed(seed, "checked"))
    sel = sorted(rng.choice(len(kept), min(len(kept),
                                           int(traffic["checked_frames"])),
                            replace=False))
    jobs = [kept[i][:3] for i in sel]
    want, _ = ref_frames(s["scene"], s["opt"], jobs, device)
    got = {"program": [kept[i][3] for i in sel]}
    out = {}
    for v in variants:
        if v not in got:
            got[v] = ref_frames(s["scene"], s["opt"], jobs, device,
                                tf32=v == "control",
                                fault=None if v == "control" else v)[0]
        out[v] = {k: x for k, (x, _) in
                  checks.frame_numbers(got[v], want).items()}
    out["frames_checked"] = len(jobs)
    return out
