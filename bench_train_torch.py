#!/usr/bin/env python3
"""Train-step throughput of the PyTorch port on one CUDA card.

    python3 bench_train_torch.py [--lpips] [--out train_bench_torch.json]

`scripts/bench_train.py` on `dimo_tpu_torch/`: a stage-2 step at the
reference scale (the flagship scene, ~100k Gaussians, 512 control
points, 4 motions x 2 views x 2 frames = 16 renders at 512^2, capacity
1024, ARAP, guidance and both smoothness terms on unless switched off),
cameras at seeded azimuths and random uint8 ground truth. The first step
is timed alone (`compile_s`: the port compiles nothing, so it is the
first step's seconds), then `--steps` steps on the host clock, ending in
a synchronize. `--lpips` adds the seeded random-VGG LPIPS
(`random_init_lpips(0)`), as the reference's script does. `--out` writes
an artifact with `train_bench.json`'s keys; the host batch keys are null
(the native batch packer is not ported) and `backend` is "cuda".

It needs a card: without one it raises before it prints anything.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--n_gauss", type=int, default=100_000)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--no_arap", action="store_true")
    ap.add_argument("--no_guidance", action="store_true")
    ap.add_argument("--no_smooth", action="store_true")
    ap.add_argument("--shape", type=str, default="4,2,2",
                    help="n_motions,n_views,n_frames")
    ap.add_argument("--lpips", action="store_true",
                    help="enable LPIPS with random-init weights (cost bench)")
    ap.add_argument("--out", default="",
                    help="write a JSON artifact with train_bench.json's keys")
    return ap.parse_args(argv)


def make_batch(params, shape, res: int, device) -> dict:
    """`scripts/bench_train.py`'s batch: cameras at RandomState(0)
    azimuths, radius 2, fov 33.9 deg; times, motion-major latent
    indices, unit MSE weights, random uint8 GT at 512^2, zero guidance."""
    from dimo_tpu_torch.utils import cameras
    n_m, n_v, n_f = shape
    b = n_m * n_v * n_f
    rng = np.random.RandomState(0)
    fov = float(np.deg2rad(33.9))
    cams = [cameras.Camera.from_c2w(
        cameras.orbit_camera(0, rng.uniform(0, 360), 2.0), fov, fov)
        for _ in range(b)]
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "camera": cams,
        "times": rng.rand(b).astype(np.float32),
        "latent_idx": np.repeat(np.arange(n_m), n_v * n_f).astype(np.int32),
        "mse_w": torch.ones(b, device=device),
        "gt_image": dev(rng.randint(0, 255, (b, res, res, 3), np.uint8)),
        "gt_mask": dev(rng.randint(0, 255, (b, res, res), np.uint8)),
        "guidance": torch.zeros((b, params.c_xyz.shape[0], 3), device=device),
    }


def artifact(args, step_s: float, first_s: float) -> dict:
    """The `--out` record: `train_bench.json`'s keys."""
    shape = [int(x) for x in args.shape.split(",")]
    return {
        "steady_step_ms": step_s * 1000, "it_per_s": 1.0 / step_s,
        "res": args.res, "batch": shape, "n_gauss": args.n_gauss,
        "tile_capacity": args.capacity, "lpips": bool(args.lpips),
        "arap": not args.no_arap, "guidance": not args.no_guidance,
        "compile_s": first_s,
        "host_batch_packer_ms": None, "host_batch_numpy_ms": None,
        "backend": "cuda",
    }


def main(argv=None) -> dict:
    from dimo_tpu_torch.models.lpips import random_init_lpips
    from dimo_tpu_torch.scenes import flagship_scene
    from dimo_tpu_torch.train.step import (LossConfig, init_state,
                                           make_train_step)
    from dimo_tpu_torch.utils.general import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cuda")
    cfg, params, aux, _ = flagship_scene(n_gauss=args.n_gauss, device=dev)
    state = init_state(params, aux, step=0)
    shape = tuple(int(x) for x in args.shape.split(","))
    batch = make_batch(params, shape, args.res, dev)
    lcfg = LossConfig(
        use_arap=not args.no_arap,
        add_depth=not args.no_smooth, add_normal=not args.no_smooth,
        add_ga=not args.no_guidance)
    lpips_fn = random_init_lpips(0, dev) if args.lpips else None
    step_fn = make_train_step(cfg, lcfg, "s2", args.res, args.res, *shape,
                              capacity=args.capacity, lpips_fn=lpips_fn,
                              use_guidance=not args.no_guidance)

    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    print(f"first step: {first_s:.2f}s  loss={float(metrics['loss']):.3f}")

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / args.steps
    print(f"steady step: {dt * 1000:.1f} ms  ({1.0 / dt:.2f} it/s)  "
          f"res={args.res} B={int(np.prod(shape))} N={args.n_gauss} "
          f"lpips={bool(args.lpips)}")
    out = artifact(args, dt, first_s)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
