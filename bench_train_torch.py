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
an artifact with `train_bench.json`'s keys, `backend` "cuda".
`--packer_probe` also times the trainer's host batch assembly, the native
packer against numpy's gather (`host_batch_packer_ms` /
`host_batch_numpy_ms`; null without it).

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
    ap.add_argument("--packer_probe", action="store_true",
                    help="also time host batch assembly packer vs numpy")
    return ap.parse_args(argv)


def packer_probe(n_views: int, n_frames: int, device, ref_size: int = 512,
                 iters: int = 30) -> tuple:
    """ms per `Trainer.sample_batch` with the dataset on the host: the
    native double-buffered packer, then numpy's gather (the reference's
    `_packer_probe`: 4 motions of random uint8 frames at ref_size,
    batch_size 2). The dataset is kept on the host (`DIMO_DEVICE_DATA=0`),
    since it is small enough to live on the card, where neither path runs;
    each call ends when its frames are on the device."""
    import os
    from dimo_tpu_torch.presets import tiny_synthetic_opt
    from dimo_tpu_torch.train.loop import Trainer

    m, v, f = 4, n_views, n_frames
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (m, v, f, ref_size, ref_size, 3), np.uint8)
    masks = rng.randint(0, 255, (m, v, f, ref_size, ref_size), np.uint8)
    meta = {"input_videos": [f"m{i}" for i in range(m)],
            "azimuths": list(np.linspace(0, 360, v, endpoint=False)),
            "elevations": [0.0] * v}
    opt = tiny_synthetic_opt(batch_size=2, num_views=v, num_frames=f,
                             ref_size=ref_size)
    held = os.environ.get("DIMO_DEVICE_DATA")
    os.environ["DIMO_DEVICE_DATA"] = "0"
    try:
        tr = Trainer(opt, images, masks, meta, device=device)
    finally:
        if held is None:
            os.environ.pop("DIMO_DEVICE_DATA")
        else:
            os.environ["DIMO_DEVICE_DATA"] = held

    def loop():
        tr.sample_batch()                      # warm: the first submit
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            tr.sample_batch()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / iters * 1000

    packer_ms = loop()
    if tr._packer is None:
        raise RuntimeError("the native batch packer did not load")
    tr._packer.close()
    tr._packer = None
    tr._packer_b = len(tr._sample_meta()["times"])   # pins numpy's gather
    tr._pending_meta = None
    return packer_ms, loop()


def artifact(args, step_s: float, first_s: float,
             packer_ms: float | None = None,
             numpy_ms: float | None = None) -> dict:
    """The `--out` record: `train_bench.json`'s keys."""
    shape = [int(x) for x in args.shape.split(",")]
    return {
        "steady_step_ms": step_s * 1000, "it_per_s": 1.0 / step_s,
        "res": args.res, "batch": shape, "n_gauss": args.n_gauss,
        "tile_capacity": args.capacity, "lpips": bool(args.lpips),
        "arap": not args.no_arap, "guidance": not args.no_guidance,
        "compile_s": first_s,
        "host_batch_packer_ms": packer_ms, "host_batch_numpy_ms": numpy_ms,
        "backend": "cuda",
    }


def main(argv=None) -> dict:
    from dimo_tpu_torch.models.lpips import random_init_lpips
    from dimo_tpu_torch.scenes import flagship_scene, train_batch
    from dimo_tpu_torch.train.step import (LossConfig, init_state,
                                           make_train_step)
    from dimo_tpu_torch.utils.general import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cuda")
    cfg, params, aux, _ = flagship_scene(n_gauss=args.n_gauss, device=dev)
    state = init_state(params, aux, step=0)
    shape = tuple(int(x) for x in args.shape.split(","))
    batch = train_batch(params, shape, args.res, dev)
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
    packer_ms = numpy_ms = None
    if args.packer_probe:
        packer_ms, numpy_ms = packer_probe(shape[1], shape[2], dev)
        print(f"host batch assembly: packer {packer_ms:.2f} ms / "
              f"numpy {numpy_ms:.2f} ms")
    out = artifact(args, dt, first_s, packer_ms, numpy_ms)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
