"""The quality run on the port: a two-stage training on synthetic videos,
scored by test-set PSNR, then the default test mode's videos.

Counterpart of `scripts/eval_quality.py`, with its configuration
(`build_config`: the same shapes, schedules, capacity ceiling 2048), its
dataset (`make_synthetic_videos(M, V, F, S, n_gauss=150, seed=0)`, the
dense oracle's renders), its gate (`PSNR_GATE` = 26.0, kept where the
reference keeps it so that a miss stays visible) and its JSON keys. The
root script `eval_quality_torch.py` calls `main`:

    python3 eval_quality_torch.py [--fast] [--no-lpips] [--iters S1,S2]
        [--out eval_quality_torch.json] [--load-stage s1]

It trains through `Trainer.train_dynamic` with elastic snapshots, scores
every (motion, view, frame) of the dataset at the trainer's live strip
capacity with the KNN computed once (`score_psnr`), and runs
`test_modes.run_default_test`. A failure of the video step does not hide
the PSNR: it is reported as `videos_ok: false` with its text under
`videos_error`. Runs on the card unless `main(..., device="cpu")`.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

PSNR_GATE = 26.0

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEFAULT_RUN_DIR = os.path.join(_REPO, "build", "eval_quality_torch")
_DEFAULT_VIDEOS = os.path.join(_REPO, "build", "eval_quality_torch_videos")


def build_config(scale512: bool = False, fast: bool = False,
                 iters: str | None = None, videos: str = _DEFAULT_VIDEOS,
                 run_dir: str = _DEFAULT_RUN_DIR):
    """(M, V, F, S, iters_s1, iters_s2, opt): the reference's dataset shape
    and Trainer options for the gate. scale512 is its reference-scale
    variant: 512^2, 8 motions, 256 control points x 200 Gaussians each."""
    from dimo_tpu_torch.presets import tiny_synthetic_opt as tiny_opt

    if scale512:
        M, V, F, S = 8, 4, 7, 512
        iters_s1, iters_s2 = 2800, 10000
    else:
        M, V, F, S = 3, 4, 7, 256
        iters_s1, iters_s2 = (120, 60) if fast else (700, 500)
    if iters:
        iters_s1, iters_s2 = (int(x) for x in iters.split(","))
    common = dict(
        ref_size=S, W=S, H=S, num_views=V, num_frames=F,
        batch_size=2, iters_s1=iters_s1, iters_s2=iters_s2,
        save_path=run_dir,
        video_save_dir=videos,
        # the reference's escalation ceiling for this gate
        tile_capacity_max=2048,
    )
    if scale512:
        opt = tiny_opt(
            latent_code_dim=32,
            num_pts=512, num_cpts=256, capacity_s1=2048, tile_capacity=1024,
            num_pts_per_cpt=200,                  # 256*200 = 51,200 gaussians
            density_start_iter=100, density_end_iter=2500,
            densification_interval=100, FPS_iter=200,
            arap_start_iter_s1=2000, arap_end_iter_s2=5000,
            **common)
    else:
        opt = tiny_opt(
            latent_code_dim=16,
            num_pts=256, num_cpts=96, capacity_s1=2048, tile_capacity=512,
            num_pts_per_cpt=128,                  # 96*128 = 12,288 gaussians
            density_start_iter=100, density_end_iter=500,
            densification_interval=100, FPS_iter=200,
            arap_start_iter_s1=300, arap_end_iter_s2=200,
            **common)
    return M, V, F, S, iters_s1, iters_s2, opt


@torch.no_grad()
def score_psnr(tr, images: np.ndarray, capacity: int) -> tuple:
    """Test-set PSNR of a stage-2 trainer: every (motion, view, frame) of
    images (M, V, F, S, S, 3) uint8 rendered at S^2 from the trainer's
    orbit camera at time f / F, white background, strip capacity
    `capacity`, the KNN computed once. Returns (psnr in dB, the per-image
    MSEs in motion, view, frame order)."""
    from dimo_tpu_torch.models.renderer import find_knn, render
    M, V, F, S = images.shape[:4]
    params, aux = tr.state.params, tr.state.aux
    bg = torch.ones(3, device=tr.device)
    knn = find_knn(params, aux)
    mses = []
    for m in range(M):
        for v in range(V):
            cam = tr.camera_for(tr.azimuths[v])
            for f in range(F):
                img = render(tr.mcfg, params, aux, cam, f / F, "s2", m, S, S,
                             bg, knn_cache=knn, capacity=capacity)["image"]
                gt = torch.from_numpy(images[m, v, f]).to(tr.device)
                gt = gt.to(torch.float32).permute(2, 0, 1) / 255.0
                mses.append(float(torch.mean((img - gt) ** 2)))
    return float(10 * np.log10(1.0 / np.mean(mses))), mses


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="shorter schedule (a smoke run; no gate)")
    ap.add_argument("--scale512", action="store_true",
                    help="reference-scale run: 512^2, 8 motions, >=50k "
                         "gaussians, full s1+s2 schedule")
    ap.add_argument("--iters", default=None,
                    help="override the schedule as S1,S2 (e.g. 1400,5000)")
    ap.add_argument("--no-lpips", action="store_true",
                    help="disable the LPIPS term")
    ap.add_argument("--out", default="eval_quality_torch.json")
    ap.add_argument("--videos", default=_DEFAULT_VIDEOS)
    ap.add_argument("--run-dir", default=_DEFAULT_RUN_DIR,
                    help="save/snapshot root")
    ap.add_argument("--snapshot-every", type=int, default=500,
                    help="elastic-resume snapshot cadence (0 disables); "
                         "re-running the same command continues an "
                         "interrupted run from the last snapshot")
    ap.add_argument("--load-stage", default="",
                    help="skip finished stages by loading their checkpoint "
                         "from the run dir (e.g. 's1' trains only s2)")
    return ap.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    from dimo_tpu_torch import test_modes
    from dimo_tpu_torch.io.synthetic import make_synthetic_videos
    from dimo_tpu_torch.models.lpips import get_lpips
    from dimo_tpu_torch.train.loop import Trainer
    from dimo_tpu_torch.utils.general import resolve_device

    args = parse_args(argv)
    dev = resolve_device(device)
    M, V, F, S, iters_s1, iters_s2, opt = build_config(
        scale512=args.scale512, fast=args.fast, iters=args.iters,
        videos=args.videos, run_dir=args.run_dir)
    images, masks, meta = make_synthetic_videos(
        num_motions=M, num_views=V, num_frames=F, ref_size=S, n_gauss=150,
        seed=0, device=dev)
    lpips_fn = None if args.no_lpips else get_lpips(
        os.path.join(_REPO, "weights", "lpips_vgg.npz"), fallback="random",
        device=dev)

    tr = Trainer(opt, images, masks, meta, device=dev)
    t0 = time.time()
    # the snapshot directory is tagged by configuration: variants (with and
    # without LPIPS, scales) must not resume each other's runs
    tag = f"snap_{S}_{iters_s1}+{iters_s2}_" \
          f"{'nolpips' if args.no_lpips else 'lpips'}"
    tr.train_dynamic(iters_s1, iters_s2, args.load_stage, lpips_fn=lpips_fn,
                     snapshot_every=args.snapshot_every,
                     snapshot_dir=os.path.join(opt.save_path, tag))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.time() - t0
    n_gauss = int(tr.state.aux.active.sum())
    print(f"[eval_quality] trained {iters_s1}+{iters_s2} steps in "
          f"{train_s:.0f}s; {n_gauss} active gaussians")

    # the trainer's LIVE (escalated) capacity: a training that escalated
    # must not be scored on a truncated render
    eval_cap = int(tr.tile_capacity)
    psnr, mses = score_psnr(tr, images, eval_cap)
    print(f"[eval_quality] test PSNR over {len(mses)} renders: {psnr:.2f} dB")

    os.makedirs(args.videos, exist_ok=True)
    videos_error = None
    try:
        test_modes.run_default_test(tr, render_type="fixed")
        videos_ok = any(f.endswith(".mp4") for f in os.listdir(args.videos))
    except Exception as e:  # video IO must not mask the PSNR result
        print("[eval_quality] video generation failed:", repr(e))
        videos_ok, videos_error = False, repr(e)

    result = {
        "psnr": round(psnr, 2),
        "gate": PSNR_GATE,
        "passed": bool(psnr >= PSNR_GATE) if not args.fast else None,
        "n_gaussians": n_gauss,
        "resolution": S,
        "motions": M,
        "iters": [iters_s1, iters_s2],
        "train_seconds": round(train_s, 1),
        "sec_per_step": round(train_s / max(iters_s1 + iters_s2, 1), 3),
        "lpips": not args.no_lpips,
        "eval_capacity": eval_cap,
        "videos_ok": videos_ok,
        "videos_error": videos_error,
        "fast": args.fast,
        "scale512": args.scale512,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print("[eval_quality]", json.dumps(result))
    if not args.fast and psnr < PSNR_GATE:
        raise SystemExit(f"PSNR {psnr:.2f} < gate {PSNR_GATE}")
    return result
