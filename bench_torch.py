#!/usr/bin/env python3
"""Render benchmark of the PyTorch port on one CUDA card: ONE JSON line.

    python3 bench_torch.py

`bench.py` on `dimo_tpu_torch/`, with its keys. Metric: stage-2
deformation-render throughput at 512x512 (the reference's `test_fps`
harness: one warm-up render, then N timed renders of TimeNet -> KNN-LBS
-> rasterizer, KNN cached once, on the ~100k-Gaussian flagship scene),
on the host clock around renders that end in a synchronize. Then the
same at 7 channels and at capacity 512; the capacity's truncation delta
against capacity 4096 with both overflow counts; and a selfcheck of the
strip rasterizer (`rasterize`) against the dense oracle on the card, in
value and in one gradient. `y_repeat` and `fwd_inloop` are TPU kernel
knobs and print null; `device` is the card's name and power limit as
nvidia-smi gives them. `vs_baseline` keeps `bench.py`'s comparison point
(~250 frames/s on an A100 for a ~100k-Gaussian 512^2 scene).

It needs a card: without one it raises before it prints anything.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import time

import numpy as np
import torch

REFERENCE_FPS_A100 = 250.0
ROUNDS = 500
CAPACITY = 1024
REF_CAPACITY = 4096
SIZE = 512


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise RuntimeError(f"nvidia-smi: rc {r.returncode} "
                           f"{r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def selfcheck(device="cuda") -> dict:
    """`rasterize` (the strip compositor's kernels on a card) against
    `rasterize_dense` on `bench.py`'s scene (400 Gaussians, 128x64,
    capacity 512): the image, and the gradient of sum(image^2) with
    respect to the opacities."""
    from dimo_tpu_torch.ops.rasterizer.api import rasterize, rasterize_dense
    from dimo_tpu_torch.utils import cameras
    from dimo_tpu_torch.utils.general import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(3)
    n = 400
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    means = t(rng.uniform(-0.5, 0.5, (n, 3)))
    scales = t(np.exp(rng.uniform(-4.5, -3.0, (n, 3))))
    quats = t(rng.randn(n, 4))
    opac = t(rng.uniform(0.2, 0.95, (n, 1)))
    sh = t(rng.uniform(-0.5, 0.5, (n, 1, 3)))
    cam = cameras.Camera.from_c2w(cameras.orbit_camera(15, 40, 2.0), 0.6, 0.6)
    bg = torch.ones(3, device=dev)
    width, height = 128, 64

    def run(fn, **kw):
        op = opac.clone().requires_grad_(True)
        img = fn(means, scales, quats, op, sh, cam, width, height, bg,
                 **kw).image
        torch.sum(img ** 2).backward()
        return img.detach(), op.grad

    img_t, g_t = run(rasterize, capacity=512)
    img_o, g_o = run(rasterize_dense)
    img_err = float((img_t - img_o).abs().max())
    g_scale = float(g_o.abs().max()) or 1.0
    g_err = float((g_t - g_o).abs().max()) / g_scale
    return {"selfcheck_img_maxerr": img_err,
            "selfcheck_grad_relerr": g_err,
            "selfcheck_ok": bool(img_err < 1e-2 and g_err < 1e-2)}


def scene_hash(params) -> str:
    """`bench.py`'s scene identity: the bytes of xyz, scaling, opacity."""
    raw = b"".join(getattr(params, k).detach().cpu().numpy().tobytes()
                   for k in ("xyz", "scaling", "opacity"))
    return f"shell-v2-{hashlib.sha256(raw).hexdigest()[:12]}"


def _render(scene, knn, channels: int, capacity: int) -> dict:
    from dimo_tpu_torch.models.renderer import render
    cfg, params, aux, cam = scene
    bg = torch.ones(3, device=params.xyz.device)
    return render(cfg, params, aux, cam, 0.0, "s2", 1, SIZE, SIZE, bg,
                  knn_cache=knn, capacity=capacity, channels=channels)


@torch.no_grad()
def timed_fps(scene, knn, channels: int, rounds: int, capacity: int) -> float:
    """Frames/s over `rounds` renders after one warm-up, host clock, the
    last render synchronized."""
    _render(scene, knn, channels, capacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        _render(scene, knn, channels, capacity)
    torch.cuda.synchronize()
    return rounds / (time.perf_counter() - t0)


@torch.no_grad()
def capacity_delta(scene, knn, capacity: int = CAPACITY,
                   ref_capacity: int = REF_CAPACITY) -> dict:
    """The ch3 image at `capacity` against `ref_capacity` (no strip
    overflows there on the flagship): the largest difference, the share
    of image values off by more than 1/255, both overflow counts."""
    a = _render(scene, knn, 3, capacity)
    b = _render(scene, knn, 3, ref_capacity)
    dd = (a["image"] - b["image"]).abs()
    return {"cap_maxdiff_vs4096": float(dd.max()),
            "cap_badpx_gt_1_255": float((dd > 1.0 / 255.0).float().mean()),
            "overflow_at_cap": int(a["overflow"]),
            "overflow_at_4096": int(b["overflow"])}


def result_line(fps: float, fps7: float, fps_cap512: float, delta: dict,
                scene: str, check: dict, device: str) -> dict:
    """The JSON line: `bench.py`'s keys and `device`."""
    from dimo_tpu_torch.ops.rasterizer import strips, tiles
    return {
        "metric": "render_fps_512_s2_100k",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / REFERENCE_FPS_A100,
        "fps_ch7": fps7,
        "fps_cap512": fps_cap512,
        "capacity": CAPACITY,
        **delta,
        "scene": scene,
        "s_per_buf": strips.S_PER_BUF,
        "y_repeat": None,
        "fwd_inloop": None,
        "strip_w": strips.STRIP_W,
        "dup": strips.DUP,
        "tier2": tiles.TIER2,
        "windma": tiles.WINDMA,
        **check,
        "device": device,
    }


def main(rounds: int = ROUNDS) -> dict:
    from dimo_tpu_torch.models.renderer import find_knn
    from dimo_tpu_torch.scenes import flagship_scene
    from dimo_tpu_torch.utils.general import resolve_device

    dev = resolve_device("cuda")
    device = card_line()
    check = selfcheck(dev)
    scene = flagship_scene(device=dev)
    with torch.no_grad():
        knn = find_knn(scene[1], scene[2])
    fps = timed_fps(scene, knn, 3, rounds, CAPACITY)
    fps7 = timed_fps(scene, knn, 7, rounds // 2, CAPACITY)
    fps_cap512 = timed_fps(scene, knn, 3, rounds // 2, 512)
    line = result_line(fps, fps7, fps_cap512, capacity_delta(scene, knn),
                       scene_hash(scene[1]), check, device)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
