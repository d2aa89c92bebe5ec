#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (K1 strip compositor, K2 LBS column
   gather) from `dimo_tpu_torch/csrc/` with nvcc, at first use.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the flagship render gives it: K2 bit-exact; K1 7-channel at
   atol 1e-5; K1 3-channel early exit against the plain exhaustive
   composite at 5e-4 (the T_EXIT tail bound).
3. Checks a small render on the card against the same render on the CPU
   (plain versions): 1e-4, except the rare pixel where one entry sits on
   the 1/255 alpha cut.
4. Drives the main path through the port's entry points at full width:
   the flagship stage-2 scene (100k Gaussians, 512 control points,
   latent 32), KNN once, a 21-frame 7-channel sequence at 512^2 with
   capacity 1024 (t = i/21, the shape of `render_sequence`), then 51
   3-channel renders at t=0 (one warm-up and 50 timed, the shape of
   `run_test_fps`). Every launch counter is zeroed just before and read
   just after; each kernel must have launched once per render.
5. Prints the per-stage breakdown (CUDA events), a `kernels` JSON line,
   the card's name and power limit, and last the device line.

Any failure raises and exits non-zero before the last line is printed.
Without a CUDA card, or outside a checkout of the repository, it exits
non-zero at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

FP32_PEAK = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12       # H100 SXM device memory, bytes/s
# K1 float32 ops per (pixel, list entry): quadratic 16, exp2 1, cut/clamp 2,
# w 1, T 1, and 2 per composited channel
K1_OPS_BASE = 21
SEQ_FRAMES = 21
FPS_ROUNDS = 50
WIDTH = HEIGHT = 512
CAPACITY = 1024


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over iters launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi: rc {r.returncode} {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    try:
        from dimo_tpu_torch import build
        from dimo_tpu_torch.models import deform, gaussians as G
        from dimo_tpu_torch.models.renderer import find_knn, render
        from dimo_tpu_torch.ops import smallgather as sg
        from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
        from dimo_tpu_torch.ops.rasterizer import projection, strips
        from dimo_tpu_torch.ops.rasterizer.api import camera_tensors
        from dimo_tpu_torch.scenes import flagship_scene
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from a checkout")

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"tf32_matmul={torch.backends.cuda.matmul.allow_tf32}")
    card = card_line()
    print("card:", card)

    # --- 1. build -------------------------------------------------------
    t0 = time.time()
    logs = build.build()
    print(f"build: {time.time() - t0:.1f} s")
    for name, log in logs.items():
        for ln in ptxas_summary(log):
            print(f"  ptxas[{name}]: {ln}")

    # --- scene at full width, KNN once ----------------------------------
    t0 = time.time()
    cfg, params, aux, cam = flagship_scene(device=dev)
    bg = torch.ones(3, device=dev)
    knn = find_knn(params, aux)
    torch.cuda.synchronize()
    print(f"scene: {params.xyz.shape[0]} gaussians, {params.c_xyz.shape[0]} "
          f"control points, latent {cfg.latent_dim}; setup+KNN "
          f"{time.time() - t0:.2f} s")

    # --- 2a. K2 against its plain version at the flagship shapes --------
    with torch.no_grad():
        lat = G.sample_latent(params, 1)
        d_xyz, d_rot = params.timenet(params.c_xyz, 0.0, lat)
        table_t = torch.cat([G.get_c_radius(params).T, params.c_xyz.T,
                             d_xyz.T, d_rot.T], dim=0).contiguous()
    nn_idx = knn[1].contiguous()
    got = sg.gather_small_cols(table_t, nn_idx)
    ref = sg.gather_small_cols_plain(table_t, nn_idx)
    torch.cuda.synchronize()
    if got.shape != (11, 4, params.xyz.shape[0]):
        fail(f"K2 shape {tuple(got.shape)}")
    k2_err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        fail(f"K2 disagrees with its plain version: max |err| {k2_err}")
    flat = nn_idx.reshape(-1).long()
    k2_ms = cuda_ms(lambda: sg.gather_small_cols(table_t, nn_idx), 200)
    k2_plain = cuda_ms(lambda: sg.gather_small_cols_plain(table_t, nn_idx), 50)
    k2_lib = cuda_ms(lambda: torch.index_select(table_t, 1, flat), 200)
    s_sites = nn_idx.numel()
    k2_bytes = s_sites * 4 + table_t.numel() * 4 + 11 * s_sites * 4
    print(f"K2 gather_small_cols (11, {table_t.shape[1]}) x {tuple(nn_idx.shape)}:"
          f" bit-exact vs plain; {k2_ms:.4f} ms (plain {k2_plain:.4f}, "
          f"index_select {k2_lib:.4f})")
    torch.cuda.synchronize()

    # --- 2b. K1 against its plain version at the flagship lists ---------
    with torch.no_grad():
        means3d, rots = deform.lbs_blend(
            params.xyz, params.rotation, params.c_xyz, d_xyz, d_rot,
            G.get_c_radius(params), knn[1], knn[0])
        wv, fp, cp = camera_tensors(cam, dev)
        p = projection.project(
            means3d, G.get_scaling(params, "s2"), rots,
            G.get_opacity(params), G.get_features(params), wv, fp, cp,
            float(cam.tan_fovx), float(cam.tan_fovy), WIDTH, HEIGHT,
            valid=aux.active)
        lists = strips.build_strip_lists(p.mean2d, p.cull_radius, p.depth,
                                         p.in_frustum, HEIGHT, WIDTH, CAPACITY)
        table = strips.coef_table(p.mean2d, p.conic, G.get_opacity(params),
                                  p.color, p.depth, p.normal, HEIGHT, WIDTH)
    ns = lists.count.shape[0]
    entries = torch.zeros(ns, dtype=torch.int32, device=dev)
    k1 = {}
    for ch, tol in ((7, 1e-5), (3, 5e-4)):
        got = cs.composite_strips(table, lists.idx, lists.count, HEIGHT, WIDTH,
                                  ch, entries_out=entries)
        ref = cs.composite_strips_plain(table, lists.idx, lists.count, HEIGHT,
                                        WIDTH, ch)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not torch.isfinite(got).all() or err > tol:
            fail(f"K1 ch{ch} disagrees with its plain version: max |err| "
                 f"{err} > {tol}")
        n_entries = int(entries.sum())
        ms = cuda_ms(lambda: cs.composite_strips(
            table, lists.idx, lists.count, HEIGHT, WIDTH, ch), 50)
        plain_ms = cuda_ms(lambda: cs.composite_strips_plain(
            table, lists.idx, lists.count, HEIGHT, WIDTH, ch), 2, warmup=1)
        ops = n_entries * 32 * 32 * (K1_OPS_BASE + 2 * ch)
        nbytes = (table.numel() * 4 + n_entries * 4 + ns * 4
                  + (ch + 1) * HEIGHT * WIDTH * 4)
        k1[ch] = dict(err=err, ms=ms, plain_ms=plain_ms, entries=n_entries,
                      ops=ops, bytes=nbytes)
        print(f"K1 composite ch{ch}{' early-exit' if ch != 7 else ''}: max |err| "
              f"{err:.3g} (tol {tol}); {ms:.4f} ms (plain {plain_ms:.2f}); "
              f"{n_entries} entries composited of {int(lists.count.sum())} "
              f"listed; overflow {int(lists.overflow)}")
    torch.cuda.synchronize()

    # --- 3. small render on the card vs the same render on the CPU ------
    small = []
    for where in (dev, torch.device("cpu")):
        c2, p2, a2, cam2 = flagship_scene(2048, 32, 8, seed=3, device=where)
        small.append([render(c2, p2, a2, cam2, 0.35, "s2", 1, 256, 256,
                             torch.ones(3, device=where), capacity=1024,
                             channels=ch) for ch in (7, 3)])
    for i, ch in enumerate((7, 3)):
        tol = 1e-4 if ch == 7 else 5e-4
        for key in ("image", "alpha", "depth", "normal"):
            a = small[0][i][key].cpu()
            b = small[1][i][key]
            scale = max(1.0, float(b.abs().max()))
            err = (a - b).abs()
            bad = int((err > tol * scale).any(dim=0).sum())
            if bad > 0.005 * err[0].numel() or float(err.max()) > 2 / 255 * scale:
                fail(f"small render ch{ch} {key}: card vs CPU max |err| "
                     f"{float(err.max())}, {bad} px over {tol}")
        print(f"small render ch{ch} 256^2: card vs CPU max |err| "
              f"{float((small[0][i]['image'].cpu() - small[1][i]['image']).abs().max()):.3g}")
    torch.cuda.synchronize()

    # --- 4. the main path ------------------------------------------------
    cs.launches = dict.fromkeys(cs.launches, 0)
    sg.launches = 0
    t0 = time.time()
    for i in range(SEQ_FRAMES):
        out = render(cfg, params, aux, cam, i / SEQ_FRAMES, "s2", 1, WIDTH,
                     HEIGHT, bg, knn_cache=knn, capacity=CAPACITY, channels=7)
        img, alpha = out["image"], out["alpha"]
        if img.shape != (3, HEIGHT, WIDTH) or not torch.isfinite(img).all():
            fail(f"frame {i}: image not finite or shape {tuple(img.shape)}")
        a_max = float(alpha.max())
        if not (a_max > 0.5 and float(alpha.mean()) > 0.01):
            fail(f"frame {i}: trivial alpha (max {a_max})")
        if out["overflow"].shape != () or out["overflow_max"].shape != ():
            fail("overflow not reported")
        for k in ("depth", "normal"):
            if not torch.isfinite(out[k]).all():
                fail(f"frame {i}: {k} not finite")
    torch.cuda.synchronize()
    seq_s = time.time() - t0
    seq_overflow = int(out["overflow"])
    img = render(cfg, params, aux, cam, 0.0, "s2", 1, WIDTH, HEIGHT, bg,
                 knn_cache=knn, capacity=CAPACITY, channels=3)["image"]
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(FPS_ROUNDS):
        img = render(cfg, params, aux, cam, 0.0, "s2", 1, WIDTH, HEIGHT, bg,
                     knn_cache=knn, capacity=CAPACITY, channels=3)["image"]
    torch.cuda.synchronize()
    fps = FPS_ROUNDS / (time.time() - t0)
    if not torch.isfinite(img).all():
        fail("ch3 image not finite")
    k1_launch = dict(cs.launches)
    k2_launch = sg.launches
    renders = SEQ_FRAMES + 1 + FPS_ROUNDS
    if k1_launch["ch7"] != SEQ_FRAMES or k1_launch["ch3"] != 1 + FPS_ROUNDS:
        fail(f"K1 launches {k1_launch}, expected ch7={SEQ_FRAMES} "
             f"ch3={1 + FPS_ROUNDS}")
    if k2_launch != renders:
        fail(f"K2 launches {k2_launch}, expected {renders}")
    print(f"main path: {SEQ_FRAMES}-frame ch7 sequence {seq_s:.3f} s "
          f"({SEQ_FRAMES / seq_s:.2f} frames/s, overflow {seq_overflow}); "
          f"ch3 {fps:.2f} fps over {FPS_ROUNDS} renders; launches "
          f"K1 {k1_launch} K2 {k2_launch}")

    # --- 5. per-stage breakdown (CUDA events; outside the counted run) --
    def stages(ch: int) -> dict:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        with torch.no_grad():
            ev[0].record()
            lat = G.sample_latent(params, 1)
            dx, dr = params.timenet(params.c_xyz, 0.0, lat)
            ev[1].record()
            kd, ki = find_knn(params, aux)
            ev[2].record()
            m3, r3 = deform.lbs_blend(params.xyz, params.rotation,
                                      params.c_xyz, dx, dr,
                                      G.get_c_radius(params), ki, kd)
            ev[3].record()
            wv, fp, cp = camera_tensors(cam, dev)
            pr = projection.project(
                m3, G.get_scaling(params, "s2"), r3, G.get_opacity(params),
                G.get_features(params), wv, fp, cp, float(cam.tan_fovx),
                float(cam.tan_fovy), WIDTH, HEIGHT, valid=aux.active)
            ev[4].record()
            ls = strips.build_strip_lists(pr.mean2d, pr.cull_radius, pr.depth,
                                          pr.in_frustum, HEIGHT, WIDTH,
                                          CAPACITY)
            ev[5].record()
            tb = strips.coef_table(pr.mean2d, pr.conic, G.get_opacity(params),
                                   pr.color, pr.depth, pr.normal, HEIGHT,
                                   WIDTH)
            ev[6].record()
            cs.composite_strips(tb, ls.idx, ls.count, HEIGHT, WIDTH, ch)
            ev[7].record()
        torch.cuda.synchronize()
        names = ("timenet", "knn", "lbs", "projection", "binning",
                 "coef_table", "composite")
        return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    for ch in (7, 3):
        runs = [stages(ch) for _ in range(12)][2:]
        mean = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
        print(f"stages ch{ch} (ms, mean of {len(runs)}): "
              + " ".join(f"{k}={v:.3f}" for k, v in mean.items())
              + f" total={sum(mean.values()):.3f}")

    # --- kernels line, card, device --------------------------------------
    def k1_row(ch: int, key: str) -> dict:
        r = k1[ch]
        t_ops = r["ops"] / FP32_PEAK * 1e3
        t_bytes = r["bytes"] / HBM_BW * 1e3
        return {"name": f"composite_strips_fwd_{key}", "route": "cuda",
                "source": "dimo_tpu_torch/csrc/composite_strips.cu",
                "replaces": "dimo_tpu/ops/rasterizer/composite_strips.py:326",
                "launches": k1_launch[key], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None, "entries": r["entries"]}

    k2_ops_ms = 0.0
    k2_bytes_ms = k2_bytes / HBM_BW * 1e3
    rows = [k1_row(7, "ch7"), k1_row(3, "ch3"),
            {"name": "gather_small_cols_fwd", "route": "cuda",
             "source": "dimo_tpu_torch/csrc/smallgather.cu",
             "replaces": "dimo_tpu/ops/smallgather.py:200",
             "launches": k2_launch, "max_abs_err": k2_err, "ms": k2_ms,
             "plain_ms": k2_plain, "bound_ms": max(k2_ops_ms, k2_bytes_ms),
             "bound_by": "bytes", "library_ms": k2_lib}]
    print(json.dumps({"fps_ch3": fps,
                      "seq_ch7_frames_per_s": SEQ_FRAMES / seq_s}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
