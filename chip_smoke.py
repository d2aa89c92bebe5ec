#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (K1 strip compositor and K3 its
   backward, K2 LBS column gather and K4 its backward, K5 the row-layout
   gather and K6 its backward, whose sorted route is also the strip
   path's row scatter, K7 the binning's window readout, K8 tile
   compositor and K9 its backward) from `dimo_tpu_torch/csrc/` with nvcc,
   one process per source, all started at once.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the flagship render gives it: K2 bit-exact, also on a ragged
   last block, S % 4 != 0, an idx view one element off 16-byte alignment,
   a transposed idx, indices -1 and M, and M = 1,024; K1 7-channel
   bit-exact; K1 3-channel early exit against the plain exhaustive
   composite at 5e-4 (the T_EXIT tail bound), its row groups stopping
   where `early_exit_entries` replays them; K3 per list slot at 1e-4 of
   each lane's max |grad| (only the order of the per-entry sums differs;
   an alpha replayed differently from K1 would show as an O(1) slot),
   bit-identical on a second run; K1 and K3 also on strip counts 0, 1,
   R-1, R, R+1, around the 64-entry chunk and at the capacity, indices -1
   and N inside lists, capacity 1000, 128^2 and 1024^2. It prints the
   strip lists' histogram, K1/K3's resident blocks per SM and the
   pixel-entry pairs with alpha > 0 that their bounds count;
   K4 bit-equal to its plain version (which sums in the kernel's fixed
   order, given the card's plan for the table route) and to itself on a
   second run, at the LBS shape, on K2's edge cases, a misaligned g view,
   every index on one column, S = 0, and M = 5,189 and 5,190 at D = 11 so
   both of its routes run (K2 bit-exact there, and the pair through
   autograd at 5,190), with its route, grid, ptxas's registers and
   resident blocks per SM;
   K7 bit-exact, at the flagship's sorted pairs and window starts
   (capacity 1024), with all starts odd or even, at capacities 63, 64 and
   2,050 with windows that start at or overrun the array end, and for a
   single bin, and the flagship's strip lists by both readout routes
   (`tiles.WINDMA` off and on) equal in all four outputs; K5 bit-exact
   and K6 bit-equal to its plain version and to itself on a second run,
   as K4, at the LBS shape ((512, 11) table, 400,000 sites), on the
   edge cases of `rows_edge_cases` (both of K6's routes) and on a
   (100000, 16) table, with ptxas's registers and the resident blocks per
   SM of K5 and K6's kernels; the strip path's row scatter
   (`gather_rows_bwd`, K6's sorted route) bit-equal to its plain version
   and to itself on a second run at the flagship frame's strip lists (K3's
   slot gradients, 256 x 1,024 x 16 into the (100001, 16) table), with
   indices -1 and N+1 among them, every slot on one row and no slot,
   timed beside `zeros + index_add_`; K8
   7-channel bit-exact and its 4- and 3-channel variants bit-equal to
   their plain versions and to the 7-channel's first planes, K9 per slab
   slot at 1e-4 of each lane's max |grad|, zero past each count and on
   lanes 13-15, bit-identical on a second run, on the flagship's tile
   lists (64 tiles, capacity 1024) and on `tile_edge_cases` (tile counts
   0, 1, 63, 64, 65, 255, 256, 257 and 1,024: K9's and K8's chunks,
   capacity 1000, 128^2 and 1024^2; K8 also on slabs of tiny, huge,
   nearly singular, faint and opaque Gaussians, which test the box it
   skips entries by); it prints the tile pixel-entry pairs
   with alpha > 0 that the bounds of K8 and K9 count, and the registers
   and resident blocks per SM of K8 (each channel variant) and K9.
   Times each kernel by CUDA events around a loop of wrapper calls (`ms`,
   the host-paced time a caller pays) and, for every kernel and the
   library calls, inside a CUDA graph (`graph_ms`, the device's own time;
   see `graph_ms`).
3. Checks a small render on the card against the same render on the CPU
   (plain versions): 1e-4, except the rare pixel where one entry sits on
   the 1/255 alpha cut. Then a small train step (2,048 Gaussians, 32
   control points, latent 8, 2 x 1 x 2 renders at 256^2): loss (rtol
   1e-4) and every parameter's gradient (relative L2 1e-3), card vs CPU.
   And a small stage-1 step (512 Gaussians in a capacity of 1,024, 2 x 1
   x 2 renders at 256^2 from a 512^2 ground truth, so the resize runs):
   loss, gradients, the `mean2d_tap` gradient, `denom`, `max_radii2d`.
   And a small tile-path render (2,048 Gaussians of ~5 px, 256^2) with the
   gradient of a weighted sum of its four outputs, card vs CPU.
4. Drives the serving path through the port's entry points at full
   width, under torch.no_grad(): the flagship stage-2 scene (100k
   Gaussians, 512 control points, latent 32), KNN once, a 21-frame
   7-channel sequence at 512^2 with capacity 1024 (t = i/21, the shape of
   `render_sequence`), then 21 3-channel renders at t=0 (one warm-up and
   20 timed, the shape of `run_test_fps` at a smaller depth). Every launch counter is zeroed
   just before and read just after; each kernel must have launched once
   per render.
5. Prints the per-stage breakdown of a render (CUDA events).
6. Drives the training path at full width, the shape of
   `scripts/bench_train.py`: the flagship scene, 4 motions x 2 views x 2
   frames = 16 renders at 512^2 per step, capacity 1024, ARAP, chamfer
   guidance and both smoothness terms on, from step 300 (every gate
   open); one warm-up and 2 timed steps. Checks a finite loss, no skipped
   step, every group with a learning rate moved, and K1 ch7 = K2 = K3 =
   K4 = the row scatter = 16 launches per step (counters zeroed just
   before, read just after). Prints the step time and its CUDA-event
   split. The loss and
   every gradient leaf of one step computed twice from the same state
   (`step_spread`) must be the same bits.
6b. The same path with LPIPS on, as the reference trains by default: the
   seeded random-VGG fallback at lambda 1000, its convolutions in float32;
   one warm-up and 2 timed steps beside phase 6's, the split with an
   `lpips` mark, the peak memory. Checks a finite loss, no skipped step, a
   non-zero LPIPS term, every group with a learning rate moved, and K1 ch7
   = K2 = K3 = K4 = the row scatter = 16 launches per step, and the same
   bits from one step computed twice (`step_spread`, LPIPS on). Then LPIPS
   in TF32 against
   float32 on one motion's 4 renders and their GT (`lpips_precision`):
   prints the differences and whether TF32 meets LPIPS_TF32_DIST_REL and
   LPIPS_TF32_GRAD_REL_L2 (it did not, so float32 ships), checks that
   neither precision is changed by cuDNN's global TF32 flag at the forward
   or at the backward (each pass sets its own), and that the step's LPIPS
   gives the float32 distances bit for bit.
6c. One test-time fine-tuning step, `trainable_groups={"latent_code"}`,
   LPIPS on: only `latent.codes` moves, every other leaf stays bit-equal,
   ARAP reads 0.
   Then one LPIPS-on step inside `utils/diagnostics.profile_trace` (the
   trace under `build/profile_lpips_step/`), and the card's busy share of
   the step's window from the trace's kernel events.
7. Drives the two-stage trainer at full width with the window readout
   route on (`tiles.WINDMA = 1`, so every render launches K7):
   `Trainer.train_dynamic` on synthetic videos rendered on the card at
   512^2 (4 motions x 3 views x 5 frames), 512 control points, latent 32,
   stage-1 capacity 8,192, 200 Gaussians per control point in stage 2
   (~100k), batch_size 2 (16 renders a step), every loss of
   `configs/train_config.yaml`, LPIPS as `main_train_dimo.py` sets it by
   default (`get_lpips`: the seeded fallback, the trained weights being
   absent; every step's LPIPS term must be non-zero). The cadence keys are set so
   that a densify that adds Gaussians, an opacity reset, an FPS anneal
   down to 512, `finish_s1`'s prune and checkpoint, `prepare_train_s2`,
   an s2 prune, mid-run snapshots, an interruption, a resume from the
   last snapshot in a fresh `Trainer`, and the final `s2/` checkpoint
   read back all happen, and each is asserted from the trainer's state.
   Then s2 steps at 256^2 and 512^2 through `train_step_once`. Every
   launch counter is zeroed just before and read just after: K7, K1 ch7,
   K3 and the row scatter must equal the phase's render count, K2 and K4
   its stage-2 render count.
7b. Two fresh `Trainer`s with one seed run the same cut
   `train_dynamic` one after the other (phase 7's videos, widths, cadence
   keys and LPIPS, no snapshots, TWIN_ITERS: the densifies at 4 and 8,
   the opacity reset, the FPS anneal, finish_s1's prune and s1 -> s2):
   every step's loss, every parameter and Adam moment, the active masks
   and every checkpoint file must be the same bits
   (`utils/diagnostics.py::run_fingerprint`); launches counted.
8. Drives the tile-compositor path at full width (the flagship scene,
   100k Gaussians, 512 control points, 512^2, capacity 1024 per tile,
   nothing cut): latent -> TimeNet -> LBS (K2) -> project ->
   build_tile_lists -> pack_attrs -> gather_rows -> composite (K8), the
   image composed, and a backward of a weighted sum of image, alpha, depth
   and normal to every parameter (K9, gather_rows' segment sum, K4), three
   frames; the same frames through `composite_infer` (3 channels); the
   row-layout gather (K5) and its backward (K6) through autograd at the
   path's own LBS table, held against the column layout. Counters zeroed
   just before, read just after: K8 ch7 = K9 = K8 ch3 = K4 = K5 = K6 = 3,
   K2 = 6, no strip kernel. Prints the share of tile entries the capacity
   drops and the first frame's difference from capacity 4096. Then the
   cross-check of the two compositor
   families on the flagship scene built with 25,000 Gaussians at capacity
   4096 (no list overflows; Gaussians whose depths tie are deactivated,
   since the two bin geometries break ties differently): tile path (K8/K9)
   vs strip path (K1/K3) within 1e-4 on 99% of the pixels of image, alpha,
   depth and normal and within one alpha-cut flip on the rest, and within
   1e-3 relative L2 in every parameter's gradient.
9. Drives the port's own CLIs (`dimo_tpu_torch/cli.py`, behind
   `main_test_dimo_torch.py` and `main_train_dimo_torch.py`) the way a
   user does, writing under `build/phase9/`. First one `render_sequence`
   of a small scene (2,048 Gaussians) from one checkpoint on the card and
   on the CPU, 5 orbit frames at 100^2 and 160^2: within 1 LSB + 1e-4
   except at alpha-cut flips (`frames_close`). Then the flagship scene
   (100,000 Gaussians, 512 control points, 4 latents, TimeNet's output
   layers seeded so the control points move) saved as an s2 checkpoint
   beside four empty motion folders, and the test CLI's body
   (`cli.test_main`, `configs/test_config.yaml`: 800^2, 21 frames, 9
   views, ref_size 576, capacity 512, batch 4) in each mode: default
   (control points, trajectories, mosaics), interpolation, paper, fps
   (500 rounds at 512^2), language (a seeded (1, 768) embedding through
   the seeded projector), test_motion and test_unaligned_motion on one
   synthetic motion made on the card, written as PNGs and read back
   through `load_videos`, at a cut depth (FT_ITERS, FT_ITERS_A/B). Then
   the train CLI's body on `input_folder=synthetic` (TRAIN_CLI_ITERS) and
   its train_dynamic=False route. Counters zeroed before and read after
   each mode and each train run; every launch count is asserted (default:
   K1 ch7 = 42 M, K2 = 21 M; fps: K1 ch3 = K2 = 501; a fine-tuning step:
   K1 ch7 = K3 = its renders, with K2 = K4 in s2). Every frame is finite,
   every flagship s2 frame an object on white (mean 150-245, std > 10);
   after test_motion only the latent moved, after test_unaligned_motion
   only the latent and TimeNet. Every writer is the real one, as a user
   runs it: without imageio the mp4s go through OpenCV, and without
   matplotlib the 3-D track videos through `viz._plot_3d_tracks_raster`
   (one printed line says which). Each 3-D track video is checked: its
   shape (21, 500, 500, 3), ink in every frame, and each control point's
   jet colour within 2 px of where the port's own projection
   (`viz._project_3d_tracks`) puts it, unless a marker drawn after it lies
   within 4 px (those are counted and printed). Prints each mode's wall
   seconds, render_sequence's ms per frame (CUDA events), the ms per 3-D
   track frame (host clock), the fps harness's frames/s, ms per
   fine-tuning step at 128^2 / 256^2 / 512^2, and the test CLI's dataset
   upload.
10. Drives this slice's paths (under `build/phase10/`). 10a: the native
   library must load (the file is printed); the flagship's PLY (100,000
   Gaussians) through the C++ codec and the numpy one, files and arrays
   equal; then phase 9's dataset shape (4 motions x 9 views x 21 frames
   at 576^2, 1.0 GB, every frame distinct) with DIMO_DEVICE_DATA=0: the
   flagship s2 checkpoint trained HOST_STEPS steps after a warm-up (16
   renders at 512^2, LPIPS off) through the packer's page-locked slots,
   every batch's device GT equal to the flat gather of its frames (read
   only after the steps), against the same steps through numpy's gather
   on the host and with the dataset on the device, the three routes in
   turns (the losses within 1e-4); launches K1 ch7 = K2 = K3 = K4 = 16 a
   step; `bench_train_torch.py`'s packer probe. 10b: a Trainer whose
   steps are made with a one-rank NCCL mesh against one without a mesh,
   two steps each from one state (loss 1e-5); then two ranks sharing the
   card over gloo
   (`parallel/check.py::card_worker`, spawned, a hard timeout): the
   flagship s2 step at data_parallel=2 against data_parallel=1 from one
   state (loss 1e-5, every gradient leaf 1e-3 relative L2, both ranks'
   parameters bit-identical, K1 ch7 = K3 = K2 = K4 = 8 a rank), and the
   fps render (ch3, 512^2, capacity 512) and the ch7 render sharded over
   both ranks, bit-equal to the unsharded render. 10c: `eval_quality_torch.py
   --fast --iters 30,20` (LPIPS on): the JSON keys, a finite PSNR, scored
   at the trainer's live capacity, and its videos written (`videos_ok`
   true, `videos_error` None).
   `python3 chip_smoke.py --phase 10` builds and runs this phase alone
   (a development run: no result line).
11. Runs `bench_torch.py`'s functions on a fresh flagship scene with
   BENCH_ROUNDS ch3 renders instead of its 500: the selfcheck (must pass),
   the frames/s, and capacity 1024's delta against 4096; prints its line
   and the fps harness's frames/s beside it.
12. Prints a summary line, a `kernels` JSON line (all nine kernels, K1 in
   both channel variants and K8 in all three; `launches` of K1 ch7, K2, K3
   and K4 and the row scatter from phase 6b, the main path, and each
   kernel's launches in every phase-9 and phase-10 run), the card's name
   and power limit, and last the device line.

Development runs that print and fail nothing, run alone after the build:
`--phase determinism` (phase 6's and 6b's step spread, LPIPS's and SSIM's
input gradients twice, phase 7b's twins) and `--phase timing` (K4, K6
and the row scatter's ms, the s2 step's ms LPIPS off and on). Both call
only entry points that older trees of the port have too, so the same
script copied into an older checkout measures that tree.

Any failure raises and exits non-zero before the last line is printed.
Without a CUDA card, or outside a checkout of the repository, it exits
non-zero at once.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

FP32_PEAK = 67e12      # H100 SXM float32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12       # H100 SXM device memory, bytes/s
# K1 float32 ops per (pixel, list entry): quadratic 16, exp2 1, cut/clamp 2,
# w 1, T 1, and 2 per composited channel. Only the quadratic is needed where
# alpha is 0 (the pair changes nothing), so the bounds of K1 and K3 count
# K1_OPS_POWER at every pair a kernel walks and the rest at the pairs with
# alpha > 0
K1_OPS_BASE = 21
K1_OPS_POWER = 16
# K3 float32 ops per (pixel, list entry): alpha replay 19 (as K1), 1/(1-a)
# 2, T 1, w 1, CG 13, dalpha 3, suffix 2, gate 2, dpower 3, the ten
# per-pixel terms 9, and one add per term into the strip's sums 10
K3_OPS = 65
# K8 float32 ops per (pixel, slab entry): the power 10, exp 1, cut/cap 2,
# w 1, T 1, and 2 per composited channel. A pixel outside the entry's box
# (`composite_tiles.entry_box`) has alpha exactly 0 without its power, so
# K8's bound counts K8_OPS_POWER at the pairs inside the box and the rest
# at the pairs with alpha > 0
K8_OPS_BASE = 15
K8_OPS_POWER = 10
# K9 float32 ops per (pixel, slab entry): the power 10, alpha 3, 1/(1-a)
# and T 3, w 1, CG 13, dalpha 3, GS 2, gate 2, dpower 2, dy and the
# per-pixel terms 10, and one add per term into the tile's sums 10. As for
# K1/K3, its live-pair bound counts K9_OPS_POWER at every pair and the
# rest at the pairs with alpha > 0
K9_OPS = 59
K9_OPS_POWER = 10
TILE_ITERS = 3                 # tile-path renders with a backward (phase 8)
CROSS_GAUSSIANS = 25_000       # the two-compositor cross-check's scene
CROSS_CAPACITY = 4096          # ... and its capacity: no list overflows
SEQ_FRAMES = 21
FPS_ROUNDS = 20
BENCH_ROUNDS = 50              # bench_torch.py's functions (it runs 500)
WIDTH = HEIGHT = 512
CAPACITY = 1024
TRAIN_SHAPE = (4, 2, 2)        # motions, views, frames (bench_train.py)
TRAIN_STEPS = 2                # timed, after one warm-up
TRAIN_START = 300              # depth/normal (> 200) and ARAP (< 2000) open
# LPIPS's convolutions in TF32 against float32 on the same renders: what
# TF32 would have had to meet to ship (the reference itself runs them in
# bf16 on the TPU, whose unit roundoff, 2^-8, is 8x TF32's). It did not
# (the gradient, `models/lpips.py`), so float32 ships
LPIPS_TF32_DIST_REL = 1e-2     # max over images of |d_tf32 - d_f32| / d_f32
LPIPS_TF32_GRAD_REL_L2 = 5e-2  # the input gradient, relative L2
# the trainer phase: stage lengths and the cadence that makes every event
# of the schedule happen within them (see main's phase 7)
S1_ITERS, S2_ITERS = 60, 10
TRAINER_OPT = dict(
    ref_size=512, H=512, W=512, fovy=49.1, radius=2, num_views=3,
    num_frames=5, num_cpts=512, latent_code_dim=32, capacity_s1=8192,
    num_pts_per_cpt=200, batch_size=2, tile_capacity=CAPACITY,
    iters_s1=S1_ITERS, iters_s2=S2_ITERS,
    # s1: the densification window is steps 2..10; densify at 4 and 8,
    # opacity reset at 10, FPS anneal at 12 (and, with nothing left to cut,
    # at 24, 36, 48, 60), then quiet steps in which the loss recovers;
    # checkpoints at 20, 40, 60
    FPS_iter=12, density_start_iter=2, density_end_iter=10,
    densification_interval=4, opacity_reset_interval=10, save_inter=20,
    # s2: prune at 8. The AG init starts every opacity at 0.05 and a step
    # moves a logit by about 0.05, so the reference's threshold of 0.01
    # would prune nothing within ten steps; 0.045 makes the prune observable
    densification_interval_s2=8, densify_opacity_threshold_s2=0.045)
SNAPSHOT_EVERY = 3             # s2 snapshots after 0, 3, 6, 9 iterations
INTERRUPT_AT = ("s2", 5)       # the first run is cut here, after a snapshot
# phase 7b, the twin trainers: TRAINER_OPT's cadence cut to the fewest
# iterations that cross the densifies at 4 and 8, the opacity reset at 10,
# the FPS anneal at 12, finish_s1's prune and s1 -> s2
TWIN_ITERS = (13, 2)           # s1, s2 iterations
TIMING_STEPS = 4               # s2 steps timed a variant by `--phase timing`
# phase 9: the test CLI on the flagship checkpoint at test_config.yaml's
# widths; the depth cuts (the reference's in brackets)
PHASE9_MOTIONS = 4             # the flagship's latents
FPS_HARNESS_ROUNDS = 500       # `run_test_fps`'s default, not cut
FT_ITERS = 3                   # test_motion's fit (1000)
FT_ITERS_A, FT_ITERS_B = 2, 2  # test_unaligned_motion's phases (400, 1000)
FT_RES_STEPS = 3               # timed fine-tuning steps at each resolution
TRAIN_CLI_ITERS = (6, 3)       # the train CLI's s1, s2 iterations (1500, 5000)
# phase 10: the native batch I/O, the parallel paths and the quality run;
# the depth cuts (the reference's in brackets)
HOST_DATA_SHAPE = (4, 9, 21, 576)  # phase 9's dataset: motions, views, frames, side
HOST_STEPS = 3                 # s2 steps a dataset route, after one warm-up
HOST_START_STEP = 449          # the s2 step the routes start after (512^2)
PARALLEL_WORLD = 2             # ranks sharing the one card (gloo)
PARALLEL_TIMEOUT_S = 420       # a rank that outlives this fails the phase
SP_FPS_ROUNDS = 20             # sharded fps renders timed (500)
QUALITY_ITERS = "30,20"        # the cut quality run (700 + 500)


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


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device milliseconds of one fn() call with the host out of the
    loop: `iters` calls captured into one CUDA graph, replayed `replays`
    times between CUDA events. `cuda_ms` of the same fn is the host-paced
    time a caller of the wrapper pays; the difference is the host's share.
    The ctypes launches land in the graph because the wrappers launch on
    `torch.cuda.current_stream()`, which is the capture stream here; a
    wrapper's launch counter moves once per captured call, not per replay.
    Back-to-back replays find the inputs in the 50 MB L2 cache, for a
    kernel and its library call alike."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def ptxas_summary(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def ptxas_kernel(log: str, name: str) -> str:
    """ptxas's spill and register/shared-memory lines for the kernel whose
    mangled name contains `name` (the first such)."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and name in ln:
            return "; ".join(x.split(":", 1)[-1].strip()
                             for x in lines[i + 1:i + 3])
    fail(f"ptxas printed nothing for a kernel named {name}")


def train_batch(params, shape, res: int, device, seed: int) -> dict:
    """`scripts/bench_train.py`'s batch on the port: cameras at numpy
    RandomState(seed) azimuths, radius 2.0, fov 33.9 deg; random uint8 GT
    images and masks at the render size; guidance = c_xyz + seeded noise."""
    import numpy as np
    import torch
    from dimo_tpu_torch.utils import cameras
    n_m, n_v, n_f = shape
    b = n_m * n_v * n_f
    rng = np.random.RandomState(seed)
    fov = float(np.deg2rad(33.9))
    cams = [cameras.Camera.from_c2w(
        cameras.orbit_camera(0, rng.uniform(0, 360), 2.0), fov, fov)
        for _ in range(b)]
    c = params.c_xyz.detach().cpu().numpy()
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "camera": cams, "times": rng.rand(b).astype(np.float32),
        "latent_idx": np.repeat(np.arange(n_m), n_v * n_f).astype(np.int32),
        "mse_w": torch.ones(b, device=device),
        "gt_image": dev(rng.randint(0, 255, (b, res, res, 3), np.uint8)),
        "gt_mask": dev(rng.randint(0, 255, (b, res, res), np.uint8)),
        "guidance": dev((c[None] + rng.randn(b, *c.shape) * 0.01
                         ).astype(np.float32)),
    }


def small_train_grads(device) -> tuple:
    """Loss and per-leaf gradients of one small s2 step (2,048 Gaussians,
    32 control points, latent 8, 2 x 1 x 2 renders at 256^2), with seeded
    TimeNet heads so every layer carries gradient."""
    import numpy as np
    import torch
    from dimo_tpu_torch.scenes import flagship_scene
    from dimo_tpu_torch.train.step import LossConfig, init_state, make_train_step
    cfg, params, aux, _ = flagship_scene(2048, 32, 8, seed=3, device=device)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for lin in (params.timenet.pts_1, params.timenet.rot_1):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.02)
    state = init_state(params, aux, step=TRAIN_START - 1)
    fn = make_train_step(cfg, LossConfig(), "s2", 256, 256, 2, 1, 2,
                         capacity=CAPACITY, use_guidance=True)
    batch = train_batch(params, (2, 1, 2), 256, device, seed=1)
    loss, _ = fn.loss_fn(state.params, state.aux, batch, TRAIN_START,
                         arap_times=np.linspace(0.05, 0.95, 8))
    loss.backward()
    return float(loss.detach()), leaf_grads(params)


def rel_l2(got, ref) -> float:
    """|got - ref| / |ref| (L2), or |got| where ref is zero."""
    import torch
    norm = float(torch.linalg.norm(ref))
    return (float(torch.linalg.norm(got - ref)) / norm if norm
            else float(torch.linalg.norm(got)))


def small_s1_step(device) -> dict:
    """One small stage-1 step (512 Gaussians in a capacity of 1,024, latent
    8, 2 x 1 x 2 renders at 256^2 from a 512^2 uint8 ground truth, step 150:
    inside the densification window, ARAP gate opened): the loss, every
    leaf's gradient and the tap's from `loss_fn`, then `denom`,
    `max_radii2d` and `xyz_grad_accum` from the full step."""
    import numpy as np
    import torch
    from dimo_tpu_torch.models import gaussians as G
    from dimo_tpu_torch.train.step import LossConfig, init_state, make_train_step
    cfg = G.ModelConfig(latent_dim=8, num_latents=2, capacity=1024,
                        cpt_capacity=64)
    params, aux = G.init_model(cfg, seed=4, num_pts=512, num_cpts=64,
                               device=device)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for lin in (params.timenet.pts_1, params.timenet.rot_1):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.02)
    batch = train_batch(params, (2, 1, 2), 512, device, seed=2)
    del batch["guidance"]
    fn = make_train_step(cfg, LossConfig(arap_start_iter_s1=100), "s1", 256,
                         256, 2, 1, 2, capacity=CAPACITY)
    times = np.linspace(0.05, 0.95, 8)
    state = init_state(params, aux, step=149, seed=8)
    tap = torch.zeros((1024, 2), device=params.xyz.device, requires_grad=True)
    loss, _ = fn.loss_fn(state.params, state.aux, batch, 150, arap_times=times,
                         generator=state.rng, tap=tap)
    loss.backward()
    grads = leaf_grads(params)
    grads["mean2d_tap"] = tap.grad.detach().cpu()
    state.rng.manual_seed(8)
    state, metrics = fn(state, batch, arap_times=times)
    return {"loss": float(loss.detach()), "grads": grads,
            "skipped": int(metrics["nonfinite_grad"]),
            "aux": {f: getattr(state.aux, f).cpu() for f in
                    ("denom", "max_radii2d", "xyz_grad_accum")}}


def k2_edge_cases(dev, table_t, nn_idx) -> list[str]:
    """K2 bit-exact against its plain version beyond the flagship shape:
    the vector path's ragged last block, the scalar path (S % 4 != 0, an
    idx view one element off 16-byte alignment, a transposed idx), indices
    out of range, and M = 1,024. Returns the cases' names."""
    import torch
    from dimo_tpu_torch.ops import smallgather as sg
    m = table_t.shape[1]
    flat = nn_idx.reshape(-1)
    bad = nn_idx.clone()
    bad[0, :7] = -1
    bad[1, :5] = m
    gen = torch.Generator().manual_seed(16)
    wide = torch.randn((11, 1024), generator=gen).to(dev)
    wide_idx = torch.randint(-1, 1025, (4, 25_000), generator=gen,
                             dtype=torch.int32).to(dev)
    cases = {
        "S = 4 x 1,001 (ragged last block)": (table_t, nn_idx[:, :1001]),
        "S = 3 x 1,001 (S % 4 != 0)": (table_t, nn_idx[:3, :1001]),
        "idx at a storage offset of one element": (table_t,
                                                   flat[1:1 + 4 * 99_999]),
        "transposed idx": (table_t, nn_idx.t()),
        "indices -1 and M": (table_t, bad),
        "M = 1,024": (wide, wide_idx),
    }
    for name, (tab, idx) in cases.items():
        got = sg.gather_small_cols(tab, idx)
        ref = sg.gather_small_cols_plain(tab, idx)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            fail(f"K2 disagrees with its plain version ({name}): max |err| "
                 f"{float((got - ref).abs().max())}")
    return list(cases)


def k4_edge_cases(dev, table_t, nn_idx) -> list[str]:
    """K4 bit-equal to its plain version (summed in the kernel's order,
    given the card's plan) and to itself on a second run, beyond the LBS
    shape: K2's cases (a ragged last block, S % 4 != 0, an
    idx view one element off 16-byte alignment, a transposed idx, indices
    -1 and M, M = 1,024), a g view one element off 16-byte alignment,
    every index on one column, S = 0, and M = 5,189 and 5,190 at D = 11,
    just under and just over the shared-memory limit, so both of K4's
    routes run; K2 bit-exact on those two tables, and `gather_small_cols`
    with its backward through autograd at M = 5,190. Returns the cases'
    names, each with K4's route."""
    import torch
    from dimo_tpu_torch.ops import smallgather as sg
    d, m = table_t.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(19)

    def rand_idx(mm, shape, lo=0, hi=None):
        return torch.randint(lo, mm if hi is None else hi, shape,
                             generator=gen, dtype=torch.int32).to(dev)

    def check(got, g, idx, mm, name, again=None):
        route, blocks, per = sg.cols_bwd_plan(
            d, mm, idx.numel(), lambda smem: sg.cols_occupancy(dev, smem)[0],
            sms)
        ref = sg.gather_small_cols_bwd_plain(
            g, idx, mm, (blocks, per) if route == "tables" else None)
        torch.cuda.synchronize()
        if got.shape != (d, mm) or not torch.equal(got, ref) or (
                again is not None and not torch.equal(got, again)):
            fail(f"K4 disagrees with its plain version or itself ({name}): "
                 f"max |err| "
                 f"{float((got - ref).abs().max()) if got.numel() else 0}")

    flat = nn_idx.reshape(-1)
    bad = nn_idx.clone()
    bad[0, :7] = -1
    bad[1, :5] = m
    # name: (m, idx, g one element off 16-byte alignment)
    cases = {
        "S = 4 x 1,001 (ragged last block)": (m, nn_idx[:, :1001], False),
        "S = 3 x 1,001 (S % 4 != 0)": (m, nn_idx[:3, :1001], False),
        "idx at a storage offset of one element": (m, flat[1:1 + 4 * 99_999],
                                                   False),
        "transposed idx": (m, nn_idx.t(), False),
        "indices -1 and M": (m, bad, False),
        "M = 1,024": (1024, rand_idx(1024, (4, 25_000), -1, 1025), False),
        "g one element off 16-byte alignment": (m, nn_idx, True),
        "every index on column 7": (
            m, torch.full((4, 25_000), 7, dtype=torch.int32, device=dev),
            False),
        "S = 0": (m, torch.zeros((4, 0), dtype=torch.int32, device=dev),
                  False),
        "M = 5,189, D = 11 (just under)": (5189, rand_idx(5189, (4, 10_000)),
                                           False),
        "M = 5,190, D = 11 (just over)": (5190, rand_idx(5190, (4, 10_000)),
                                          False),
    }
    names = []
    for name, (mm, idx, skew) in cases.items():
        g = torch.randn((d,) + tuple(idx.shape), generator=gen).to(dev)
        if skew:
            buf = torch.empty(g.numel() + 1, device=dev)
            buf[1:] = g.reshape(-1)
            g = buf[1:].view(g.shape)
            if g.data_ptr() % 16 == 0:
                fail(f"K4 edge case {name}: the g view is aligned")
        check(sg.gather_small_cols_bwd(g, idx, mm), g, idx, mm, name,
              sg.gather_small_cols_bwd(g, idx, mm))
        if mm > 1024:
            tab = torch.randn((d, mm), generator=gen).to(dev)
            got = sg.gather_small_cols(tab, idx)
            if not torch.equal(got, sg.gather_small_cols_plain(tab, idx)):
                fail(f"K2 disagrees with its plain version ({name})")
        route = sg.cols_bwd_plan(
            d, mm, idx.numel(), lambda smem: sg.cols_occupancy(dev, smem)[0],
            sms)[0]
        names.append(f"{name} [K4 {route}]")
    # the large table through autograd: K2 forward, K4 backward
    tab = torch.randn((d, 5190), generator=gen).to(dev).requires_grad_(True)
    idx = rand_idx(5190, (4, 10_000))
    out = sg.gather_small_cols(tab, idx)
    gg = torch.randn(out.shape, generator=gen).to(dev)
    out.backward(gg)
    if not torch.equal(out.detach(), sg.gather_small_cols_plain(tab.detach(),
                                                                idx)):
        fail("K2 disagrees with its plain version under autograd at M = 5,190")
    check(tab.grad, gg, idx, 5190, "autograd at M = 5,190")
    names.append("gather_small_cols and its backward through autograd at "
                 "M = 5,190")
    return names


def rows_edge_cases(dev) -> list[str]:
    """K5 bit-exact against its plain version, and K6 bit-equal to its
    plain version (summed in the kernel's order, given the card's plan)
    and to itself on a second run, beyond the LBS shape: S % 4 != 0, idx
    and g as views one element off 16-byte alignment, D in {1, 3, 4, 11,
    16, 33}, M = 1, M x D just under and just over K6's shared-memory
    limit (so both of K6's routes run), every index on one row, indices
    -1 and M only, and S = 0. Returns the cases' names, each with K6's
    route."""
    import torch
    from dimo_tpu_torch.ops import smallgather as sg
    gen = torch.Generator().manual_seed(18)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def rand_idx(m, s, lo=0, hi=None):
        return torch.randint(lo, m if hi is None else hi, (s,), generator=gen,
                             dtype=torch.int32)

    def off_by_one(t):
        """A copy of t that starts one element into its storage."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype)
        buf[1:] = t.reshape(-1)
        return buf.to(dev)[1:].view(t.shape)

    # (m, d, idx (cpu), misaligned)
    cases = {"S = 40,003 (S % 4 != 0)": (512, 11, rand_idx(512, 40_003), False),
             "idx and g one element off 16-byte alignment":
                 (512, 11, rand_idx(512, 40_000), True)}
    for d in (1, 3, 4, 11, 16, 33):
        cases[f"D = {d}, M = 512"] = (512, d, rand_idx(512, 40_000), False)
        cases[f"D = {d}, M = 64"] = (64, d, rand_idx(64, 40_000), False)
    cases["M = 1"] = (1, 11, rand_idx(1, 40_000, -1, 2), False)
    cases["M = 5,189, D = 11 (just under)"] = (
        5189, 11, rand_idx(5189, 40_000), False)
    cases["M = 5,190, D = 11 (just over)"] = (
        5190, 11, rand_idx(5190, 40_000), False)
    cases["every index on row 7"] = (512, 11, torch.full((100_000,), 7,
                                                         dtype=torch.int32),
                                     False)
    cases["indices -1 and M only"] = (
        512, 11, torch.where(rand_idx(2, 40_000) == 0, -1, 512).int(), False)
    cases["S = 0"] = (512, 11, torch.zeros((0,), dtype=torch.int32), False)
    names = []
    for name, (m, d, idx, skew) in cases.items():
        tab = torch.randn((m, d), generator=gen).to(dev)
        g = torch.randn((idx.shape[0], d), generator=gen)
        if skew:
            idx_d, g_d = off_by_one(idx), off_by_one(g)
            if idx_d.data_ptr() % 16 == 0 or g_d.data_ptr() % 16 == 0:
                fail(f"K5/K6 edge case {name}: the views are aligned")
        else:
            idx_d, g_d = idx.to(dev), g.to(dev)
        got = sg.gather_small(tab, idx_d)
        ref = sg.gather_small_plain(tab, idx_d)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            fail(f"K5 disagrees with its plain version ({name}): max |err| "
                 f"{float((got - ref).abs().max()) if got.numel() else 0}")
        route, blocks, per = sg.rows_bwd_plan(
            m, d, idx.shape[0], lambda smem: sg.rows_occupancy(dev, smem)[1],
            sms)
        got = sg.gather_small_bwd(g_d, idx_d, m)
        again = sg.gather_small_bwd(g_d, idx_d, m)
        ref = sg.gather_small_bwd_plain(
            g_d, idx_d, m, (blocks, per) if route == "tables" else None)
        torch.cuda.synchronize()
        if got.shape != (m, d) or not torch.equal(got, ref) or \
                not torch.equal(got, again):
            fail(f"K6 disagrees with its plain version or itself ({name}): "
                 f"max |err| {float((got - ref).abs().max())}")
        names.append(f"{name} [K6 {route}]")
    return names


def k7_edge_cases(dev, pairs, starts, capacity) -> list[str]:
    """K7 bit-exact against its plain version beyond the flagship windows:
    odd and even starts, an odd capacity (the scalar path), starts == ND,
    windows that overrun the array end, a single bin. Returns the cases'
    names."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import windowdma as wd
    nd = pairs.shape[0]
    end = starts.clone()
    end[-4:] = torch.tensor([nd - 70, nd - 40, nd - 3, nd], dtype=torch.int32,
                            device=dev)
    cases = {
        "odd starts": (torch.clamp_max(starts | 1, nd), capacity),
        "even starts": (starts & ~1, capacity),
        "capacity 63": (starts, 63),
        "capacity 63, odd starts": (torch.clamp_max(starts | 1, nd), 63),
        "starts == ND and past the array end": (end, capacity),
        "capacity 64 past the array end": (end, 64),
        "capacity 63 past the array end": (end, 63),
        "capacity 2,050 (three chunks)": (end, 2050),
        "a single bin": (starts[7:8], capacity),
        "a single bin at the array end": (end[-2:-1], capacity),
    }
    for name, (st, cap) in cases.items():
        got = wd.gather_windows(pairs, st, cap)
        ref = wd.gather_windows_plain(pairs, st, cap)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.equal(got, ref):
            fail(f"K7 disagrees with its plain version ({name})")
    got = wd.gather_windows(pairs, end, 64)
    if bool(got[-1].any()) or not bool(got[-2, :3].any()) \
            or bool(got[-2, 3:].any()):
        fail("K7 reads past the array end")
    return list(cases)


def strip_histogram(count, capacity: int) -> str:
    """One line on the strip lists' lengths: min, max, mean, deciles, how
    many are at capacity, and the longest two (what one SM walked back to
    back when a 1,024-thread block per strip ran in two waves)."""
    import torch
    c = count.float()
    top = torch.topk(count, 2).values.tolist()
    dec = torch.quantile(c, torch.linspace(0.1, 0.9, 9, device=c.device))
    return (f"{count.numel()} strips, counts min {int(c.min())} max "
            f"{int(c.max())} mean {float(c.mean()):.1f}, deciles "
            f"{[int(v) for v in dec.tolist()]}, {int((count >= capacity).sum())}"
            f" at capacity {capacity}, longest pair {top[0] + top[1]}")


def strip_occupancy() -> dict:
    """Resident blocks per SM of K1 ch7, K1 ch3, K3 and K3's group pass,
    from the CUDA occupancy API on the kernels as built."""
    import ctypes
    from dimo_tpu_torch import build
    blocks = (ctypes.c_int * 4)()
    fn = build.function("composite_strips", "composite_strips_occupancy",
                        [ctypes.c_void_p])
    build.check(fn(ctypes.addressof(blocks)), "composite_strips_occupancy")
    return dict(zip(("ch7", "ch3", "bwd", "combine"), blocks))


def pair_counts(table, idx, walked, height: int, width: int) -> tuple:
    """(pixel, list entry) pairs a strip compositor visits when row group g
    of strip s walks the first walked[s, g] entries of its list, and how
    many of those have alpha > 0 (the pairs that change the result)."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    ns, groups = walked.shape
    rows = cs.STRIP_H // groups
    pl = cs._plain_planes(table, idx, height, width, 1)
    live = torch.zeros((), dtype=torch.int64, device=table.device)
    for j in range(int(walked.max()) if ns else 0):
        a, _ = cs._alpha(pl, j)
        on = (j < walked).repeat_interleave(rows, dim=1)       # (Ns, 32)
        live += ((a > 0) & on[:, :, None]).sum()
    return int(walked.sum()) * rows * cs.STRIP_W, int(live)


def check_strip_kernels(table, idx, count, height: int, width: int,
                        name: str) -> dict:
    """K1 ch7 bit-exact against its plain version; K1 ch3 within 5e-4 of
    the plain exhaustive composite (the T_EXIT tail), with the entries its
    row groups walk equal to `early_exit_entries`' replay; K3 per list slot
    within 1e-4 of each lane's max |grad| (only the order of the sums over
    the strip differs), zero past each count and on the id lanes, and
    bit-identical on a second run (no atomics)."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    ns, cap = idx.shape
    entries = torch.zeros(ns, dtype=torch.int32, device=table.device)
    got7 = cs.composite_strips(table, idx, count, height, width, 7,
                               entries_out=entries)
    ref7 = cs.composite_strips_plain(table, idx, count, height, width, 7)
    n = torch.clamp(count, 0, cap)
    if not torch.equal(got7, ref7):
        fail(f"K1 ch7 is not bit-exact against its plain version ({name}): "
             f"max |err| {float((got7 - ref7).abs().max())}")
    if not torch.equal(entries, n):
        fail(f"K1 ch7 did not walk every list entry ({name})")
    n_entries = int(entries.sum())
    got3 = cs.composite_strips(table, idx, count, height, width, 3,
                               entries_out=entries)
    ref3 = cs.composite_strips_plain(table, idx, count, height, width, 3)
    err3 = float((got3 - ref3).abs().max())
    if not torch.isfinite(got3).all() or err3 > 5e-4:
        fail(f"K1 ch3 disagrees with its plain version ({name}): max |err| "
             f"{err3} > 5e-4")
    walk = cs.early_exit_entries(table, idx, count, height, width)
    if not torch.equal(entries.long(), walk.max(1).values):
        fail(f"K1 ch3's row groups stop elsewhere than the replay ({name})")
    tfin = got7[7].contiguous()
    gout = torch.randn((8, height, width),
                       generator=torch.Generator().manual_seed(11)).to(
                           table.device)
    got = cs.composite_strips_bwd(table, idx, count, tfin, gout)
    again = cs.composite_strips_bwd(table, idx, count, tfin, gout)
    ref = cs.composite_strips_bwd_plain(table, idx, count, tfin, gout)
    lane_max = ref.abs().amax(dim=(0, 1))                  # (16,)
    err = (got - ref).abs()
    bad_slots = int((err > 1e-4 * lane_max).any(dim=-1).sum())
    past = torch.arange(cap, device=table.device)[None, :] >= n[:, None]
    if not torch.isfinite(got).all() or bad_slots or bool(got[past].any()) \
            or bool(got[..., 13:].any()):
        fail(f"K3 disagrees with its plain version ({name}): {bad_slots} list "
             f"slots over 1e-4 of their lane's max |grad| (worst "
             f"{float((err / lane_max.clamp_min(1e-30)).max()):.3g})")
    if not torch.equal(got, again):
        fail(f"K3 differs between two runs ({name})")
    return dict(entries=n_entries, entries3=int(entries.sum()), walk=walk,
                err3=err3, tfin=tfin, gout=gout,
                k3_err=float(err.max()),
                k3_rel=float((err / lane_max.clamp_min(1e-30)).max()))


def strip_edge_cases(dev, lists_at) -> list[str]:
    """`check_strip_kernels` on lists built for the row-group layout's
    edges: strip counts 0, 1, R-1, R, R+1, one below, at and above the
    chunk, and the capacity (given to the longest lists, dummy slots past
    them), indices -1 and N inside lists, a capacity that is no multiple
    of a chunk, a grid of fewer strips than SMs and one of more than two
    waves. lists_at(h, w, capacity) -> (table, lists, projection).
    Returns the cases' names."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    r = cs.ROWS_PER_THREAD
    special = ([0, 1, r - 1, r, r + 1]
               + [cs.CHUNK + k for k in (-1, 0, 1)] + [CAPACITY])
    table, lists, _ = lists_at(HEIGHT, WIDTH, CAPACITY)
    idx, count = lists.idx.clone(), lists.count.clone()
    longest = torch.argsort(count, descending=True, stable=True)
    count[longest[:len(special)]] = torch.tensor(special, dtype=torch.int32,
                                                 device=dev)
    dummy = table.shape[0] - 1
    idx[torch.arange(CAPACITY, device=dev)[None, :] >= count[:, None]] = dummy
    idx[longest[len(special)], 5:9] = -1
    idx[longest[len(special) + 1], 10:14] = dummy
    cases = {(f"{WIDTH}^2 strip counts "
              + ", ".join(str(v) for v in special)
              + "; indices -1 and N inside two lists"):
             (table, idx, count, HEIGHT, WIDTH)}
    for h, w, cap, what in ((HEIGHT, WIDTH, 1000, "capacity 1000"),
                            (128, 128, CAPACITY, "128^2"),
                            (1024, 1024, CAPACITY, "1024^2")):
        tb, ls, _ = lists_at(h, w, cap)
        blocks = ls.count.numel() * cs.GROUPS
        cases[f"{what} ({ls.count.numel()} strips, {blocks} blocks)"] = (
            tb, ls.idx, ls.count, h, w)
    for name, (tb, ix, cnt, h, w) in cases.items():
        check_strip_kernels(tb, ix, cnt, h, w, name)
    torch.cuda.synchronize()
    return list(cases)


def rows_gather_phase(dev, table_t, nn_idx, log: str) -> dict:
    """Phase 2f: K5 and K6 against their plain versions at the LBS shape
    (the (M, 11) table K2 reads, transposed, at the flagship's (4, N) KNN
    indices), K6 twice (bit-equal to its plain version, which sums in its
    order given the card's plan, and to itself), timed beside the library
    calls; ptxas's registers and the resident blocks per SM of K5 and K6's
    kernels (`log`: the smallgather build log); the edge cases; then a
    (100000, 16) table (the sorted route), untimed."""
    import torch
    from dimo_tpu_torch.ops import smallgather as sg
    table = table_t.T.contiguous()                       # (M, 11)
    m, d = table.shape
    flat = nn_idx.reshape(-1).long()
    s_sites = flat.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = sg.rows_bwd_smem(m, d)
    occ = dict(zip(("K5", "K6 block", "K6 combine"),
                   sg.rows_occupancy(dev, smem)))
    route, blocks, per_block = sg.rows_bwd_plan(
        m, d, s_sites, lambda b: sg.rows_occupancy(dev, b)[1], sms)
    if route != "tables":
        fail(f"K6 takes the {route} route at the LBS shape ({m}, {d})")
    ptx = {k: ptxas_kernel(log, n) for k, n in (
        ("K5", "gather_rows_kernel"), ("K6 block", "scatter_block_kernelILb0"),
        ("K6 combine", "combine_tables"),
        ("K6 sorted tiles", "segment_tiles_kernelILb0"),
        ("K6 sorted runs", "segment_runs_kernelILb0"))}
    for k, v in ptx.items():
        print(f"  {k}: ptxas {v}" + (f"; {occ[k]} resident blocks per SM"
                                     if k in occ else ""))
    print(f"K6 table route at ({m}, {d}): {smem} bytes of shared memory a "
          f"block, {blocks} blocks of {per_block} sites, scratch "
          f"{blocks * smem} bytes")
    got = sg.gather_small(table, nn_idx)
    ref = sg.gather_small_plain(table, nn_idx)
    torch.cuda.synchronize()
    k5_err = float((got - ref).abs().max())
    if got.shape != (*nn_idx.shape, d) or not torch.equal(got, ref):
        fail(f"K5 disagrees with its plain version: max |err| {k5_err}")
    g6 = torch.randn((*nn_idx.shape, d),
                     generator=torch.Generator().manual_seed(14)).to(dev)
    got = sg.gather_small_bwd(g6, nn_idx, m)
    again = sg.gather_small_bwd(g6, nn_idx, m)
    ref = sg.gather_small_bwd_plain(g6, nn_idx, m, (blocks, per_block))
    torch.cuda.synchronize()
    k6_err = float((got - ref).abs().max())
    identical = torch.equal(got, again)
    if not (torch.equal(got, ref) and identical):
        fail(f"K6 at the LBS shape: equal to its plain version "
             f"{torch.equal(got, ref)} (max |err| {k6_err}), the same bits "
             f"on a second run {identical}")
    print("K6 at the LBS shape: bit-equal to its plain version (the same "
          "order) and bit-identical on a second run")
    edge = rows_edge_cases(dev)
    print("K5 (bit-exact) and K6 (bit-equal to its plain version, and on a "
          "second run) also on: " + "; ".join(edge))
    g6_flat = g6.reshape(-1, d)
    k5_ms = cuda_ms(lambda: sg.gather_small(table, nn_idx), 200)
    k6_ms = cuda_ms(lambda: sg.gather_small_bwd(g6, nn_idx, m), 200)
    k5_plain = cuda_ms(lambda: sg.gather_small_plain(table, nn_idx), 50)
    k6_plain = cuda_ms(lambda: sg.gather_small_bwd_plain(g6, nn_idx, m), 5)
    k5_lib = cuda_ms(lambda: torch.index_select(table, 0, flat), 200)
    k6_lib = cuda_ms(lambda: torch.zeros((m, d), device=dev).index_add_(
        0, flat, g6_flat), 200)
    k5_graph = graph_ms(lambda: sg.gather_small(table, nn_idx), 200)
    k6_graph = graph_ms(lambda: sg.gather_small_bwd(g6, nn_idx, m), 200)
    k5_lib_graph = graph_ms(lambda: torch.index_select(table, 0, flat), 200)
    k6_lib_graph = graph_ms(lambda: torch.zeros((m, d), device=dev).index_add_(
        0, flat, g6_flat), 200)
    print(f"K5 gather_small ({m}, {d}) x {tuple(nn_idx.shape)}: bit-exact vs "
          f"plain; {k5_ms:.4f} ms (plain {k5_plain:.4f}, index_select "
          f"{k5_lib:.4f}); in a CUDA graph {k5_graph:.5f} ms (index_select "
          f"{k5_lib_graph:.5f})")
    print(f"K6 gather_small bwd ({s_sites}, {d}) -> ({m}, {d}): max |err| "
          f"{k6_err:.3g}; {k6_ms:.4f} ms (plain {k6_plain:.4f}, index_add_ "
          f"{k6_lib:.4f}); in a CUDA graph {k6_graph:.5f} ms (index_add_ "
          f"{k6_lib_graph:.5f})")
    # a large table, some indices out of range
    gen = torch.Generator().manual_seed(15)
    big = torch.randn((100_000, 16), generator=gen).to(dev)
    bidx = torch.randint(-3, 100_003, (200_000,), generator=gen,
                         dtype=torch.int32).to(dev)
    bg_ = torch.randn((200_000, 16), generator=gen).to(dev)
    got = sg.gather_small(big, bidx)
    if not torch.equal(got, sg.gather_small_plain(big, bidx)):
        fail("K5 disagrees with its plain version on a (100000, 16) table")
    got = sg.gather_small_bwd(bg_, bidx, 100_000)
    again = sg.gather_small_bwd(bg_, bidx, 100_000)
    ref = sg.gather_small_bwd_plain(bg_, bidx, 100_000)
    torch.cuda.synchronize()
    big_err = float((got - ref).abs().max())
    if not (torch.equal(got, ref) and torch.equal(got, again)):
        fail(f"K6 disagrees with its plain version or itself on a (100000, "
             f"16) table: max |err| {big_err}")
    print(f"K5/K6 on a (100000, 16) table, 200000 sites "
          f"({int(((bidx < 0) | (bidx >= 100_000)).sum())} out of range): K5 "
          f"bit-exact, K6 (sorted route) bit-equal to its plain version and "
          f"on a second run")
    nbytes = s_sites * 4 + m * d * 4 + s_sites * d * 4
    return {"k5": dict(err=k5_err, ms=k5_ms, plain_ms=k5_plain, lib_ms=k5_lib,
                       graph_ms=k5_graph, lib_graph_ms=k5_lib_graph,
                       bytes=nbytes, ptxas=ptx["K5"],
                       blocks_per_sm=occ["K5"]),
            "k6": dict(err=k6_err, ms=k6_ms, plain_ms=k6_plain, lib_ms=k6_lib,
                       graph_ms=k6_graph, lib_graph_ms=k6_lib_graph,
                       bytes=nbytes, k6_route=route, bit_identical=identical,
                       ptxas=[ptx["K6 block"], ptx["K6 combine"],
                              ptx["K6 sorted tiles"], ptx["K6 sorted runs"]],
                       blocks_per_sm=[occ["K6 block"], occ["K6 combine"]],
                       grid=blocks)}


def row_scatter_phase(dev, table, lists, tfin, gout, log: str) -> dict:
    """Phase 2h: the strip path's row scatter (`gather_rows_bwd`, the
    sorted route's kernels) at the shape the main path gives it: K3's
    per-slot row gradients of the flagship frame (256 strips x 1,024 slots
    x 16 floats) into the (N+1, 16) coefficient table, N = 100,000.
    Bit-equal to its plain version, which sums in the same order, and to
    itself on a second run; also with indices -1 and N+1 among the slots,
    with every slot on one row, and with no slot. Timed beside `zeros +
    index_add_`, the design it replaces. ptxas's registers."""
    import torch
    from dimo_tpu_torch.ops import smallgather as sg
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    from dimo_tpu_torch.ops.rasterizer import gather as rg
    m = table.shape[0]
    idx = lists.idx
    dslot = cs.composite_strips_bwd(table, idx, lists.count, tfin, gout)
    flat = idx.reshape(-1)
    s_slots = flat.numel()
    gen = torch.Generator().manual_seed(21)

    def check(g, ix, name):
        got = rg.gather_rows_bwd(g, ix, m)
        again = rg.gather_rows_bwd(g, ix, m)
        ref = sg.scatter_sorted_plain(g.reshape(-1, 16),
                                      ix.reshape(-1).long(), m)
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(got, again)):
            fail(f"the row scatter disagrees with its plain version or "
                 f"itself ({name}): max |err| "
                 f"{float((got - ref).abs().max())}")

    check(dslot, idx, "the flagship frame")
    bad = idx.clone()
    bad[:, :3] = -1
    bad[:, 3:5] = m
    noise = torch.randn(dslot.shape, generator=gen).to(dev)
    check(noise, bad, "indices -1 and N+1")
    check(noise, torch.full_like(idx, 7), "every slot on row 7")
    check(noise[:, :0], idx[:, :0], "no slot")
    ptx = {k: ptxas_kernel(log, n) for k, n in (
        ("tiles", "segment_tiles_kernelILb0"),
        ("runs", "segment_runs_kernelILb0"))}
    dummy = int((flat == m - 1).sum())
    fn = lambda: rg.gather_rows_bwd(dslot, idx, m)            # noqa: E731
    g2 = dslot.reshape(-1, 16)
    flat_l = flat.long()
    lib = lambda: torch.zeros((m, 16), device=dev).index_add_(  # noqa: E731
        0, flat_l, g2)
    out = {"ms": cuda_ms(fn, 50), "graph_ms": graph_ms(fn, 50),
           "lib_ms": cuda_ms(lib, 50), "lib_graph_ms": graph_ms(lib, 50),
           "plain_ms": cuda_ms(
               lambda: sg.scatter_sorted_plain(g2, flat_l, m), 2, warmup=1),
           "bytes": s_slots * 4 + s_slots * 16 * 4 + m * 16 * 4,
           "err": 0.0, "ptxas": [ptx["tiles"], ptx["runs"]],
           "slots": s_slots, "dummy_slots": dummy}
    print(f"row scatter ({tuple(dslot.shape)} -> ({m}, 16); {dummy} of "
          f"{s_slots} slots on the dummy row): bit-equal to its plain "
          f"version and on a second run, also with indices -1 and N+1, every "
          f"slot on one row, no slot; {out['ms']:.4f} ms (plain "
          f"{out['plain_ms']:.2f}, zeros + index_add_ {out['lib_ms']:.4f}); "
          f"in a CUDA graph {out['graph_ms']:.5f} ms (zeros + index_add_ "
          f"{out['lib_graph_ms']:.5f}); ptxas: tiles {ptx['tiles']}; runs "
          f"{ptx['runs']}")
    return out


def tile_occupancy() -> dict:
    """Resident blocks per SM of K9, of its group pass and of K8 at 7, 4
    and 3 channels, from the CUDA occupancy API on the kernels as built."""
    import ctypes
    from dimo_tpu_torch import build
    blocks = (ctypes.c_int * 5)()
    fn = build.function("composite_tiles", "composite_tiles_occupancy",
                        [ctypes.c_void_p])
    build.check(fn(ctypes.addressof(blocks)), "composite_tiles_occupancy")
    return dict(zip(("bwd", "combine", 7, 4, 3), blocks))


def tile_pair_counts(packed, counts) -> tuple:
    """(pixel, slab entry) pairs the tile compositor visits (every live
    entry at every pixel of its tile), how many of those lie inside the
    entry's box (`composite_tiles.entry_box`: the pairs whose power K8
    needs) and how many have alpha > 0 (the pairs that change the
    result)."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    from dimo_tpu_torch.ops.rasterizer import tiles
    nt, cap = packed.shape[:2]
    k = ct._coeffs(packed, counts.shape[1])
    x, y = ct._pixel_axes(packed)
    cnt = counts.reshape(-1).clamp(0, cap)
    live = torch.zeros((), dtype=torch.int64, device=packed.device)
    for j in range(int(cnt.max()) if nt else 0):
        a, _ = ct._alpha(k, j, x, y, (cnt > j)[:, None, None])
        live += (a > 0).sum()
    # whole pixels in [lo, hi] of each axis, clipped to the tile
    box = ct.entry_box(packed, counts.shape[1])
    span = lambda lo, hi, n: (torch.floor(hi).clamp(-1, n - 1)    # noqa: E731
                              - torch.ceil(lo).clamp(0, n) + 1).clamp_min(0)
    inside = (span(box[..., 0], box[..., 1], tiles.TILE_W)
              * span(box[..., 2], box[..., 3], tiles.TILE_H))
    valid = torch.arange(cap, device=packed.device)[None, :] < cnt[:, None]
    in_box = int(inside[valid].to(torch.float64).sum())
    return int(cnt.sum()) * tiles.TILE_H * tiles.TILE_W, in_box, int(live)


def check_tile_fwd(packed, counts, height: int, width: int,
                   name: str) -> tuple:
    """K8 ch7 bit-exact against its plain version, and K8 ch4 and ch3
    bit-equal to theirs and to ch7's first planes. Returns ({channels: max
    |err|}, ch7's T_final)."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    out7, tfin = ct.composite(packed, counts, height, width)
    ref7, ref_t = ct.composite_tiles_plain(packed, counts, height, width)
    torch.cuda.synchronize()
    err7 = max(float((out7 - ref7).abs().max()),
               float((tfin - ref_t).abs().max()))
    if not torch.isfinite(out7).all() or not (torch.equal(out7, ref7)
                                              and torch.equal(tfin, ref_t)):
        fail(f"K8 ch7 is not bit-exact against its plain version ({name}): "
             f"max |err| {err7}")
    errs = {7: err7}
    for ch in (4, 3):
        out, tf = ct.composite_infer(packed, counts, height, width, ch)
        ref, ref_tf = ct.composite_tiles_plain(packed, counts, height, width,
                                               ch)
        torch.cuda.synchronize()
        errs[ch] = max(float((out - ref).abs().max()),
                       float((tf - ref_tf).abs().max()))
        if not (torch.equal(out, ref) and torch.equal(tf, ref_tf)):
            fail(f"K8 ch{ch} is not bit-equal to its plain version ({name}): "
                 f"max |err| {errs[ch]}")
        if not (torch.equal(out, out7[:ch]) and torch.equal(tf, tfin)):
            fail(f"K8 ch{ch} differs from the first planes of K8 ch7 "
                 f"({name})")
    return errs, tfin


def check_tile_kernels(packed, counts, height: int, width: int,
                       name: str) -> dict:
    """`check_tile_fwd`; then K9 per slab slot within 1e-4 of each lane's
    max |grad| (only the order of the sums over the tile differs), zero
    past each count and on lanes 13-15, and bit-identical on a second run
    (no atomics)."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    nt, cap = packed.shape[:2]
    errs, tfin = check_tile_fwd(packed, counts, height, width, name)
    gout = torch.randn((8, height, width),
                       generator=torch.Generator().manual_seed(13)).to(
                           packed.device)
    got = ct.composite_tiles_bwd(packed, counts, tfin, gout)
    again = ct.composite_tiles_bwd(packed, counts, tfin, gout)
    ref = ct.composite_tiles_bwd_plain(packed, counts, tfin, gout)
    torch.cuda.synchronize()
    lane_max = ref.abs().amax(dim=(0, 1))                  # (16,)
    err = (got - ref).abs()
    bad_slots = int((err > 1e-4 * lane_max).any(dim=-1).sum())
    rel = float((err / lane_max.clamp_min(1e-30)).max())
    n = counts.reshape(-1).clamp(0, cap)
    past = torch.arange(cap, device=packed.device)[None, :] >= n[:, None]
    if not torch.isfinite(got).all() or bad_slots or bool(got[past].any()) \
            or bool(got[..., 13:].any()):
        fail(f"K9 disagrees with its plain version ({name}): {bad_slots} slab "
             f"slots over 1e-4 of their lane's max |grad| (worst {rel:.3g})")
    if not torch.equal(got, again):
        fail(f"K9 differs between two runs ({name})")
    return dict(errs=errs, tfin=tfin, gout=gout, k9_err=float(err.max()),
                k9_rel=rel, bad_slots=bad_slots)


def hard_tile_slabs(dev, seed: int) -> tuple:
    """Slabs of 2 x 4 tiles, capacity 512, random counts, of Gaussians
    that test K8's box (`entry_box`): tiny (0.2-0.6 px), huge (20-300 px),
    nearly degenerate (|correlation| 0.99-0.99999), faint (opacity
    0.0035-0.0045, at the cut) and opaque (opacity 1) ones, and in each
    tile a few far off with a flat conic, with a singular conic and with
    a negative one. Returns (packed, counts, height, width)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    nr, nc, cap = 2, 4, 512
    rows = np.zeros((nr * nc, cap, 16), np.float32)
    for t in range(nr * nc):
        xo, yo = (t % nc) * 128, (t // nc) * 32
        kind = rng.randint(0, 5, cap)
        sig = np.where(kind == 0, rng.uniform(0.2, 0.6, cap),
                       np.where(kind == 1, rng.uniform(20, 300, cap),
                                rng.uniform(0.6, 8, cap)))
        rows[t, :, 0] = rng.uniform(xo - 4 * sig, xo + 128 + 4 * sig)
        rows[t, :, 1] = rng.uniform(yo - 4 * sig, yo + 32 + 4 * sig)
        ca = rng.uniform(0.2, 5, cap) / sig ** 2
        cc = rng.uniform(0.2, 5, cap) / sig ** 2
        rho = np.where(kind == 2, rng.uniform(0.99, 0.99999, cap)
                       * rng.choice([-1, 1], cap), rng.uniform(-0.9, 0.9, cap))
        rows[t, :, 2], rows[t, :, 3], rows[t, :, 4] = (
            ca, rho * np.sqrt(ca * cc), cc)
        rows[t, :, 5] = np.where(kind == 3, rng.uniform(0.0035, 0.0045, cap),
                                 np.where(kind == 4, 1.0,
                                          rng.uniform(0, 1, cap)))
        rows[t, :, 6:13] = rng.rand(cap, 7)
        rows[t, :8, 0] = xo + rng.uniform(-2000, 2000, 8)
        rows[t, :8, 2:5] = [1e-6, 0.0, 1e-6]
        rows[t, 8:12, 3] = np.sqrt(rows[t, 8:12, 2] * rows[t, 8:12, 4])
        rows[t, 12:14, 2] = -0.1
    counts = rng.randint(0, cap + 1, (nr, nc)).astype(np.int32)
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(counts).to(dev),
            nr * 32, nc * 128)


def tile_edge_cases(dev, lists_at, opacity) -> list[str]:
    """`check_tile_kernels` on slabs built for the edges of K8's and K9's
    layouts: tile counts 0, 1, chunk - 1, chunk, chunk + 1 for each
    kernel's chunk and the capacity (given to the longest lists; slab
    rows past a count keep their Gaussians, which neither kernel may
    read), capacity 1000 (no multiple of either chunk), 128^2 (4 tiles:
    fewer blocks than SMs) and 1024^2 (256 tiles, 1,024 blocks); then
    `check_tile_fwd` (K8 alone: K9's tolerance is not meant for singular
    conics) on four `hard_tile_slabs`. lists_at(h, w, capacity) ->
    (table, lists, projection). Returns the cases' names."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    from dimo_tpu_torch.ops.rasterizer import tiles
    from dimo_tpu_torch.ops.rasterizer.tile_path import tile_slabs
    # composite_tiles.cu: K9's kBwdChunk; K8's kFwdChunk, one entry a thread
    chunks = (64, tiles.TILE_W * (tiles.TILE_H // ct.GROUPS) // ct.COLS)

    def slabs(h, w, cap):
        pr = lists_at(h, w, CAPACITY)[2]
        with torch.no_grad():
            packed, tl = tile_slabs(pr, opacity, w, h, cap)
        return packed, tl.count.reshape(tiles.num_tiles(h, w)).contiguous()

    packed, counts = slabs(HEIGHT, WIDTH, CAPACITY)
    special = sorted({0, 1, CAPACITY}
                     | {c + d for c in chunks for d in (-1, 0, 1)})
    flat = counts.reshape(-1).clone()
    longest = torch.argsort(flat, descending=True, stable=True)
    flat[longest[:len(special)]] = torch.tensor(special, dtype=torch.int32,
                                                device=dev)
    cases = {(f"{WIDTH}^2 tile counts " + ", ".join(map(str, special))
              + f" ({int((flat == CAPACITY).sum())} at capacity)"):
             (packed, flat.reshape(counts.shape), HEIGHT, WIDTH)}
    for h, w, cap, what in ((HEIGHT, WIDTH, 1000, "capacity 1000"),
                            (128, 128, CAPACITY, "128^2"),
                            (1024, 1024, CAPACITY, "1024^2")):
        pk, cn = slabs(h, w, cap)
        cases[f"{what} ({cn.numel()} tiles, {cn.numel() * ct.GROUPS} "
              f"blocks)"] = (pk, cn, h, w)
    for name, (pk, cn, h, w) in cases.items():
        check_tile_kernels(pk, cn, h, w, name)
    hard = [f"K8 alone on hard slabs, seed {seed}" for seed in range(4)]
    for seed, name in enumerate(hard):
        check_tile_fwd(*hard_tile_slabs(dev, seed), name)
    return list(cases) + hard


def tile_kernels_phase(dev, p, opacity, lists_at, log: str) -> dict:
    """Phase 2g: K8 and K9 against their plain versions on the flagship's
    tile lists (512^2, capacity 1024: slabs of (64, 1024, 16)) and on
    `tile_edge_cases`; the pixel-entry pairs inside K8's box and with
    alpha > 0; ptxas's registers and the resident blocks per SM of K8
    (each channel variant) and K9 (`log`: the composite_tiles build log);
    timed."""
    import torch
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    from dimo_tpu_torch.ops.rasterizer import tiles
    from dimo_tpu_torch.ops.rasterizer.tile_path import tile_slabs
    with torch.no_grad():
        packed, tl = tile_slabs(p, opacity, WIDTH, HEIGHT, CAPACITY)
    nrows, ncols = tiles.num_tiles(HEIGHT, WIDTH)
    counts = tl.count.reshape(nrows, ncols).contiguous()
    cn = tl.count.float()
    entries = int(tl.count.sum())
    print(f"tile lists {nrows} x {ncols}, capacity {CAPACITY}: counts min "
          f"{int(cn.min())} max {int(cn.max())} mean {float(cn.mean()):.0f} "
          f"sum {entries}; overflow {int(tl.overflow)} (worst tile "
          f"{int(tl.overflow_max)})")
    occ = tile_occupancy()
    ptx = {k: ptxas_kernel(log, n) for k, n in (
        ("bwd", "composite_tiles_bwd_kernel"), ("combine", "combine_groups"),
        *((ch, f"composite_tiles_fwd_kernelILi{ch}E") for ch in (7, 4, 3)))}
    nblocks = nrows * ncols * ct.GROUPS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for k, v in ptx.items():
        print(f"  {'K9 ' + k if k in ('bwd', 'combine') else f'K8 ch{k}'}: "
              f"ptxas {v}; {occ[k]} resident blocks per SM")
    print(f"K8 layout: {nblocks} blocks of 256 threads at {WIDTH}^2 "
          f"({ct.GROUPS} row groups a tile, {ct.COLS} columns of one row a "
          f"thread), {nblocks / (sms * occ[7]):.2f} waves at ch7")
    print(f"K9 layout: {nblocks} blocks of 256 threads at {WIDTH}^2 "
          f"({ct.GROUPS} row groups a tile, 4 rows a thread), "
          f"{nblocks / (sms * occ['bwd']):.2f} waves; scratch "
          f"{nrows * ncols * ct.GROUPS * CAPACITY * tiles.ATTR_DIM * 4} bytes")
    chk = check_tile_kernels(packed, counts, HEIGHT, WIDTH,
                             "the flagship tiles")
    tfin, gout = chk["tfin"], chk["gout"]
    pairs, in_box, live = tile_pair_counts(packed, counts)
    print(f"tile pixel-entry pairs: {pairs}, of which inside K8's box "
          f"{in_box} ({in_box / pairs:.4f}), alpha > 0 {live} "
          f"({live / pairs:.4f})")
    edge = tile_edge_cases(dev, lists_at, opacity)
    print("K8 (ch7 bit-exact, ch4 and ch3 bit-equal to their plain versions "
          "and to ch7's first planes) and K9 (1e-4 of each lane's max, zeros "
          "past the count, bit-identical twice) also on: " + "; ".join(edge))
    res = {"entries": entries, "pairs": pairs, "in_box": in_box,
           "live": live}
    for ch in (7, 4, 3):
        fn = ((lambda: ct.composite(packed, counts, HEIGHT, WIDTH)) if ch == 7
              else (lambda ch=ch: ct.composite_infer(packed, counts, HEIGHT,
                                                     WIDTH, ch)))
        res[ch] = dict(
            err=chk["errs"][ch], ms=cuda_ms(fn, 50), graph_ms=graph_ms(fn, 50),
            plain_ms=cuda_ms(lambda: ct.composite_tiles_plain(
                packed, counts, HEIGHT, WIDTH, ch), 2, warmup=1),
            ops=(in_box * K8_OPS_POWER
                 + live * (K8_OPS_BASE + 2 * ch - K8_OPS_POWER)),
            dense_ops=pairs * (K8_OPS_BASE + 2 * ch),
            bytes=(entries * 64 + counts.numel() * 4
                   + (ch + 1) * HEIGHT * WIDTH * 4),
            ptxas=ptx[ch], blocks_per_sm=occ[ch])
        print(f"K8 composite_tiles ch{ch}: "
              + ("bit-exact vs plain" if ch == 7 else
                 "bit-equal to its plain version and to the first planes of "
                 "ch7")
              + f"; {res[ch]['ms']:.4f} ms, in a CUDA graph "
              f"{res[ch]['graph_ms']:.4f} ms (plain "
              f"{res[ch]['plain_ms']:.2f}); {entries} entries")
    k9_bytes = (entries * 64 + counts.numel() * 4 + 9 * HEIGHT * WIDTH * 4
                + packed.numel() * 4)
    res["bwd"] = dict(
        err=chk["k9_err"], rel=chk["k9_rel"],
        ms=cuda_ms(lambda: ct.composite_tiles_bwd(packed, counts, tfin, gout),
                   20),
        graph_ms=graph_ms(lambda: ct.composite_tiles_bwd(packed, counts, tfin,
                                                         gout), 20),
        plain_ms=cuda_ms(lambda: ct.composite_tiles_bwd_plain(
            packed, counts, tfin, gout), 1, warmup=1),
        ops=pairs * K9_OPS_POWER + live * (K9_OPS - K9_OPS_POWER),
        dense_ops=pairs * K9_OPS, bytes=k9_bytes,
        ptxas=[ptx["bwd"], ptx["combine"]],
        blocks_per_sm=[occ["bwd"], occ["combine"]])
    print(f"K9 composite_tiles bwd: 0 slots over tol; max |err| "
          f"{chk['k9_err']:.3g} ({chk['k9_rel']:.3g} of the lane max); "
          f"bit-identical on a second run; {res['bwd']['ms']:.4f} ms, in a "
          f"CUDA graph {res['bwd']['graph_ms']:.4f} ms (plain "
          f"{res['bwd']['plain_ms']:.2f}); {entries} entries")
    return res


def tile_loss(out, gen_seed: int = 17):
    """A fixed weighted sum of a render's image, alpha, depth and normal
    (weights in [0.5, 1.5] from a seed), so every plane carries gradient."""
    import torch
    gen = torch.Generator().manual_seed(gen_seed)
    total = 0.0
    for plane in (out["image"], out["alpha"], out["depth"], out["normal"]):
        w = torch.rand(plane.shape, generator=gen) + 0.5
        total = total + (plane * w.to(plane.device)).sum()
    return total


def tile_render(cfg, params, aux, cam, t, size, bg, knn, capacity,
                channels=7) -> dict:
    """`render_tiles` with the image clipped as `models.renderer.render`
    clips it, as a dict of the four planes and the overflow."""
    from dimo_tpu_torch.ops import grad_conventions as gc
    from dimo_tpu_torch.ops.rasterizer.tile_path import render_tiles
    out = render_tiles(cfg, params, aux, cam, t, 1, size, size, bg, knn,
                       capacity=capacity, channels=channels)
    return {"image": gc.clip(out.image, 0.0, 1.0), "alpha": out.alpha,
            "depth": out.depth, "normal": out.normal,
            "overflow": out.overflow}


def leaf_grads(params) -> dict:
    import torch
    from dimo_tpu_torch.train import optim
    return {k: (v.grad.detach().cpu().clone() if v.grad is not None
                else torch.zeros_like(v).cpu())
            for k, v in optim.named_leaves(params).items()}


def trainable_scene(n_gauss, n_cpts, latent, seed, device, scale=1.0):
    """A flagship-style scene with every leaf trainable and seeded TimeNet
    heads, so that the deformation moves and every layer carries
    gradient; plus its KNN. `scale` multiplies every Gaussian's extent."""
    import math
    import torch
    from dimo_tpu_torch.models.renderer import find_knn
    from dimo_tpu_torch.scenes import flagship_scene
    from dimo_tpu_torch.train import optim
    cfg, params, aux, cam = flagship_scene(n_gauss, n_cpts, latent, seed=seed,
                                           device=device)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for lin in (params.timenet.pts_1, params.timenet.rot_1):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.02)
        params.scaling.add_(math.log(scale))
    for leaf in optim.named_leaves(params).values():
        leaf.requires_grad_(True)
    return cfg, params, aux, cam, find_knn(params, aux)


def small_tile_render(device) -> tuple:
    """Phase 3d: one small tile-path render (2,048 Gaussians, 32 control
    points, latent 8, 256^2, capacity 1024) and the gradient of
    `tile_loss` to every leaf. The Gaussians are five times the flagship's
    size, ~5 px on screen: the tile compositor expands its quadratic in a
    128-px frame, and at the flagship's ~1 px at 256^2 the float32 rounding
    of that expansion (~1e-3 in power) is a function of the inputs' last
    bits, which the card and the CPU do not share."""
    import torch
    cfg, params, aux, cam, knn = trainable_scene(2048, 32, 8, 3, device,
                                                 scale=5.0)
    out = tile_render(cfg, params, aux, cam, 0.35, 256,
                      torch.ones(3, device=device), knn, 1024)
    tile_loss(out).backward()
    return ({k: v.detach().cpu() for k, v in out.items()}, leaf_grads(params))


def compare_planes(a: dict, b: dict, tol: float, what: str,
                   max_px_frac: float = 0.005) -> float:
    """|a - b| <= tol * scale on all but `max_px_frac` of the pixels of each
    plane, and within one alpha-cut flip (2/255 * scale) everywhere.
    Returns the largest error."""
    worst = 0.0
    for key in ("image", "alpha", "depth", "normal"):
        scale = max(1.0, float(b[key].abs().max()))
        err = (a[key] - b[key]).abs()
        bad = int((err > tol * scale).any(dim=0).sum())
        if bad > max_px_frac * err[0].numel() \
                or float(err.max()) > 2 / 255 * scale:
            fail(f"{what} {key}: max |err| {float(err.max())}, {bad} px over "
                 f"{tol}")
        worst = max(worst, float(err.max()))
    return worst


def compare_grads(got: dict, ref: dict, tol: float, what: str,
                  noise_floor: float = 0.0) -> tuple:
    """Relative L2 of every leaf's gradient <= tol. With a `noise_floor`, a
    leaf whose reference gradient is rounding noise (under that share of
    the positions' gradient norm) must be noise in both and is not
    compared. Returns the worst (leaf, relative L2)."""
    import torch
    noise = noise_floor * float(torch.linalg.norm(ref["xyz"]))
    worst = ("", 0.0)
    for k, r in ref.items():
        if float(torch.linalg.norm(r)) < noise:
            if float(torch.linalg.norm(got[k])) >= noise:
                fail(f"{what}: gradient of {k} is noise on one side only")
            print(f"{what}: gradient of {k} is rounding noise on both "
                  f"sides, not compared")
            continue
        rel = rel_l2(got[k], r)
        if not rel <= tol:
            fail(f"{what}: gradient of {k} relative L2 {rel}")
        worst = max(worst, (k, rel), key=lambda kv: kv[1])
    return worst


def drop_depth_ties(cfg, params, aux, cam, t, knn) -> tuple:
    """Deactivate every Gaussian whose view depth lies within two steps of
    the binning's 22-bit depth quantization of the Gaussian in front of it.
    Both bin geometries sort a bin by quantized depth and break ties by
    the order in which keys were emitted (footprint slot, then index),
    which differs between 32 x 128 tiles and 32 x 32 strips; with ties
    gone, the two lists hold every pixel's entries in the same order.
    Returns (aux with the ties inactive, how many were dropped)."""
    import torch
    from dimo_tpu_torch.models import deform, gaussians as G
    from dimo_tpu_torch.ops.rasterizer import projection, tiles
    from dimo_tpu_torch.ops.rasterizer.api import camera_tensors
    with torch.no_grad():
        lat = G.sample_latent(params, 1)
        d_xyz, d_rot = params.timenet(params.c_xyz, t, lat)
        m3, r3 = deform.lbs_blend(params.xyz, params.rotation, params.c_xyz,
                                  d_xyz, d_rot, G.get_c_radius(params, "s2"),
                                  knn[1], knn[0])
        wv, fp, cp = camera_tensors(cam, m3.device)
        pr = projection.project(
            m3, G.get_scaling(params, "s2"), r3, G.get_opacity(params),
            G.get_features(params), wv, fp, cp, float(cam.tan_fovx),
            float(cam.tan_fovy), WIDTH, HEIGHT, valid=aux.active)
        seen = pr.in_frustum & (pr.cull_radius > 0)
        depth = torch.where(seen, pr.depth, torch.inf)
        order = torch.argsort(depth)
        d = depth[order]
        span = float(d[seen.sum() - 1] - d[0])
        step = 2.0 * span / (1 << tiles.DEPTH_BITS_MAX)
        tied = torch.zeros_like(seen)
        tied[order[1:]] = (d[1:] - d[:-1] < step) & torch.isfinite(d[1:])
    return aux.replace(active=aux.active & ~tied), int(tied.sum())


def cross_check(dev) -> tuple:
    """The two compositor families against each other on one scene that
    neither list overflows and in which no two depths tie: the tile path
    (K8/K9) and the strip path (K1/K3) in image, alpha, depth and normal,
    and in the gradient of `tile_loss` to every leaf. Returns
    (max |err|, worst relative L2)."""
    import torch
    from dimo_tpu_torch.models.renderer import render
    from dimo_tpu_torch.train import optim
    t0 = time.time()
    bg = torch.ones(3, device=dev)
    cfg, params, aux, cam, knn = trainable_scene(CROSS_GAUSSIANS, 512, 32, 0,
                                                 dev)
    aux, n_tied = drop_depth_ties(cfg, params, aux, cam, 0.35, knn)
    res = {}
    for name in ("tiles", "strips"):
        for leaf in optim.named_leaves(params).values():
            leaf.grad = None
        if name == "tiles":
            out = tile_render(cfg, params, aux, cam, 0.35, WIDTH, bg, knn,
                              CROSS_CAPACITY)
        else:
            out = render(cfg, params, aux, cam, 0.35, "s2", 1, WIDTH, HEIGHT,
                         bg, knn_cache=knn, capacity=CROSS_CAPACITY)
        if int(out["overflow"]) != 0:
            fail(f"cross-check: the {name} lists overflow by "
                 f"{int(out['overflow'])} at capacity {CROSS_CAPACITY}")
        tile_loss(out).backward()
        res[name] = ({k: out[k].detach() for k in ("image", "alpha", "depth",
                                                   "normal")},
                     leaf_grads(params))
    if float(res["tiles"][0]["alpha"].max()) <= 0.5:
        fail("cross-check: trivial alpha")
    # 1% of the pixels may exceed 1e-4: the tile compositor expands its
    # quadratic in a 128-px-wide local frame, so at this scene's ~2 px
    # Gaussians (conics ~0.2) the terms reach ~1.6e3 and their float32
    # rounding ~2e-4 in power, four times the strips' 32-px frame
    x_err = compare_planes(res["tiles"][0], res["strips"][0], 1e-4,
                           "tile path vs strip path", max_px_frac=0.01)
    x_worst = compare_grads(res["tiles"][1], res["strips"][1], 1e-3,
                            "tile path (K9) vs strip path (K3)",
                            noise_floor=1e-6)
    print(f"cross-check, the flagship scene built with {CROSS_GAUSSIANS} "
          f"Gaussians ({n_tied} deactivated: depth within two quantization "
          f"steps of the one in front) at capacity {CROSS_CAPACITY} (overflow "
          f"0 in both lists): tile path (K8/K9) vs strip path (K1/K3) max "
          f"|err| {x_err:.3g} over image, alpha, depth, normal; worst "
          f"parameter gradient {x_worst[0]} relative L2 {x_worst[1]:.3g} "
          f"({time.time() - t0:.1f} s)")
    return x_err, x_worst[1]


def tile_path_phase(dev) -> dict:
    """Phase 8: the tile-compositor path at full width, forward and
    backward, the same frames through `composite_infer`, the row-layout
    gather at the path's own LBS table, and the cross-check of the two
    compositor families. Returns launch counts and timings."""
    import torch
    from dimo_tpu_torch.models import gaussians as G
    from dimo_tpu_torch.ops import smallgather as sg
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    from dimo_tpu_torch.ops.rasterizer import gather as rg
    from dimo_tpu_torch.ops.rasterizer import projection, tiles
    from dimo_tpu_torch.ops.rasterizer.api import camera_tensors
    from dimo_tpu_torch.models import deform
    from dimo_tpu_torch.train import optim
    t_phase = time.time()
    cfg, params, aux, cam, knn = trainable_scene(100_000, 512, 32, 0, dev)
    leaves = optim.named_leaves(params)
    bg = torch.ones(3, device=dev)
    times = [i / TILE_ITERS for i in range(TILE_ITERS)]

    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    images, overflow = [], 0
    for i, t in enumerate(times):
        for leaf in leaves.values():
            leaf.grad = None
        out = tile_render(cfg, params, aux, cam, t, WIDTH, bg, knn, CAPACITY)
        for k in ("image", "alpha", "depth", "normal"):
            if not torch.isfinite(out[k]).all():
                fail(f"tile path frame {i}: {k} not finite")
        if out["image"].shape != (3, HEIGHT, WIDTH):
            fail(f"tile path frame {i}: image {tuple(out['image'].shape)}")
        alpha = out["alpha"].detach()
        if not (float(alpha.max()) > 0.5 and float(alpha.mean()) > 0.01):
            fail(f"tile path frame {i}: trivial alpha (max "
                 f"{float(alpha.max())}, mean {float(alpha.mean())})")
        tile_loss(out).backward()
        grads = leaf_grads(params)
        for k, g in grads.items():
            if not torch.isfinite(g).all():
                fail(f"tile path frame {i}: gradient of {k} not finite")
        dead = sorted(k for k in ("xyz", "scaling", "rotation", "opacity",
                                  "features_dc", "c_xyz", "c_radius",
                                  "latent.codes")
                      if float(grads[k].abs().sum()) == 0)
        if dead or not any(float(g.abs().sum()) > 0 for k, g in grads.items()
                           if k.startswith("timenet.")):
            fail(f"tile path frame {i}: no gradient reached {dead or 'TimeNet'}")
        images.append(out["image"].detach())
        overflow = int(out["overflow"])
    torch.cuda.synchronize()
    fb_ms = (time.time() - t0) / TILE_ITERS * 1e3
    t0 = time.time()
    with torch.no_grad():
        for i, t in enumerate(times):
            out3 = tile_render(cfg, params, aux, cam, t, WIDTH, bg, knn,
                               CAPACITY, channels=3)
            err = float((out3["image"] - images[i]).abs().max())
            if not torch.isfinite(out3["image"]).all() or err > 1e-6 \
                    or bool(out3["depth"].any()) or bool(out3["normal"].any()):
                fail(f"tile path frame {i}: composite_infer's image differs "
                     f"from the 7-channel one by {err}")
    torch.cuda.synchronize()
    infer_ms = (time.time() - t0) / TILE_ITERS * 1e3

    # the row-layout gather at this path's LBS table: K5 against what K2
    # reads, K6 against what K4 adds, through autograd
    with torch.no_grad():
        lat = G.sample_latent(params, 1)
        d_xyz, d_rot = params.timenet(params.c_xyz, times[-1], lat)
        rows = torch.cat([G.get_c_radius(params, "s2"), params.c_xyz, d_xyz,
                          d_rot], dim=1).contiguous()          # (M, 11)
    nn_idx = knn[1].contiguous()
    w = torch.randn((*nn_idx.shape, rows.shape[1]),
                    generator=torch.Generator().manual_seed(16)).to(dev)
    for _ in range(TILE_ITERS):
        tab = rows.clone().requires_grad_(True)
        got = sg.gather_small(tab, nn_idx)
        (got * w).sum().backward()
    cols = sg.gather_small_cols_plain(rows.T.contiguous(), nn_idx)
    ref_grad = sg.gather_small_cols_bwd_plain(w.permute(2, 0, 1).contiguous(),
                                              nn_idx, rows.shape[0]).T
    mass = sg.gather_small_cols_bwd_plain(
        w.abs().permute(2, 0, 1).contiguous(), nn_idx, rows.shape[0]).T
    torch.cuda.synchronize()
    if not torch.equal(got.detach().permute(2, 0, 1), cols):
        fail("gather_small differs from gather_small_cols transposed")
    if bool(((tab.grad - ref_grad).abs() > 1e-5 * mass + 1e-30).any()):
        fail("gather_small's table gradient differs from the column "
             "layout's, transposed")

    launch = {"K8 ch7": ct.launches["ch7"], "K8 ch3": ct.launches["ch3"],
              "K8 ch4": ct.launches["ch4"], "K9": ct.launches["bwd"],
              "K2": sg.launches,
              "K4": sg.bwd_launches, "K5": sg.rows_launches,
              "K6": sg.rows_bwd_launches, "row scatter": rg.launches}
    want = {"K8 ch7": TILE_ITERS, "K8 ch3": TILE_ITERS, "K8 ch4": 0,
            "K9": TILE_ITERS,
            "K2": 2 * TILE_ITERS, "K4": TILE_ITERS, "K5": TILE_ITERS,
            "K6": TILE_ITERS, "row scatter": TILE_ITERS}
    if launch != want or any(cs.launches.values()):
        fail(f"tile path launches {launch} (strip kernels {cs.launches}), "
             f"expected {want} and no strip kernel")
    print(f"tile path: {TILE_ITERS} renders with backward at {WIDTH}^2, "
          f"{params.xyz.shape[0]} Gaussians, capacity {CAPACITY} (tile "
          f"overflow {overflow}): {fb_ms:.1f} ms per forward + backward, "
          f"{infer_ms:.1f} ms per 3-channel render (host clock, first "
          f"iterations included); gather_small at the path's LBS table equal "
          f"to the column layout's; launches {launch}")

    # what capacity 1024 drops from this scene's tile lists, and what that
    # does to the first frame: the same frame at capacity 4096 (outside the
    # counted run)
    with torch.no_grad():
        full = tile_render(cfg, params, aux, cam, times[0], WIDTH, bg, knn,
                           CROSS_CAPACITY, channels=3)
    delta = (full["image"] - images[0]).abs()
    cap_delta = {"max": float(delta.max()), "mean": float(delta.mean()),
                 "px_over_1e-2": int((delta > 1e-2).any(dim=0).sum()),
                 "overflow_at_4096": int(full["overflow"])}
    if not torch.isfinite(full["image"]).all():
        fail("tile path at capacity 4096: image not finite")

    # per-stage CUDA events of the tile path (outside the counted run)
    frame0 = {}

    def stages() -> dict:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        with torch.no_grad():
            lat = G.sample_latent(params, 1)
            dx, dr = params.timenet(params.c_xyz, 0.0, lat)
            m3, r3 = deform.lbs_blend(params.xyz, params.rotation,
                                      params.c_xyz, dx, dr,
                                      G.get_c_radius(params, "s2"), knn[1],
                                      knn[0])
            wv, fp, cp = camera_tensors(cam, dev)
            opac = G.get_opacity(params)
            ev[0].record()
            pr = projection.project(
                m3, G.get_scaling(params, "s2"), r3, opac,
                G.get_features(params), wv, fp, cp, float(cam.tan_fovx),
                float(cam.tan_fovy), WIDTH, HEIGHT, valid=aux.active)
            ev[1].record()
            tl = tiles.build_tile_lists(pr.mean2d, pr.cull_radius, pr.depth,
                                        pr.in_frustum, HEIGHT, WIDTH, CAPACITY)
            ev[2].record()
            attrs = tiles.pack_attrs(pr.mean2d, pr.conic, opac, pr.color,
                                     pr.depth, pr.normal,
                                     radius=pr.cull_radius)
            packed = attrs[tl.idx.long()]
            ev[3].record()
            counts = tl.count.reshape(tiles.num_tiles(HEIGHT, WIDTH))
            o7, tf = ct.composite(packed, counts, HEIGHT, WIDTH)
            ev[4].record()
            ct.composite_tiles_bwd(packed, counts, tf,
                                   torch.cat([o7, tf[None]]))
            ev[5].record()
        torch.cuda.synchronize()
        frame0["lists"] = tl
        names = ("projection", "tile_lists", "pack_gather", "k8", "k9")
        return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}

    runs = [stages() for _ in range(12)][2:]
    stage_ms = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
    print(f"tile path stages (ms, mean of {len(runs)}): "
          + " ".join(f"{k}={v:.3f}" for k, v in stage_ms.items()))

    listed = int(frame0["lists"].count.sum())
    dropped = int(frame0["lists"].overflow)
    print(f"tile path frame 0 at capacity {CAPACITY}: {listed} entries "
          f"listed, {dropped} dropped ({dropped / (listed + dropped):.1%} of "
          f"{listed + dropped}); image vs capacity {CROSS_CAPACITY} (overflow "
          f"{cap_delta['overflow_at_4096']}): max |delta| "
          f"{cap_delta['max']:.4g}, mean {cap_delta['mean']:.4g}, "
          f"{cap_delta['px_over_1e-2']} of {WIDTH * HEIGHT} px over 1e-2")

    del params, leaves, images
    x_err, x_rel = cross_check(dev)
    print(f"tile path phase {time.time() - t_phase:.1f} s")
    return {"launch": launch, "stage_ms": stage_ms, "fb_ms": fb_ms,
            "infer_ms": infer_ms, "cross_err": x_err,
            "cross_grad": x_rel, "entries_listed": listed,
            "entries_dropped": dropped, "capacity_delta": cap_delta}


def step_spread(step_fn, state, batch, lcfg) -> dict:
    """The loss and every leaf's gradient of one s2 step, computed twice
    from the same state, inputs and ARAP times (no update between): the
    largest |difference| of the loss, and of each leaf with its share of
    the leaf's max |grad|, and whether both runs gave the same bits. They
    must: K4, K6 and the row scatter add in fixed orders, and cuDNN runs
    the LPIPS convolutions by deterministic algorithms."""
    import torch
    from dimo_tpu_torch.train import optim
    times = torch.rand((lcfg.arap_t_samples,),
                       generator=torch.Generator().manual_seed(7))
    leaves = optim.named_leaves(state.params)
    runs = []
    for _ in range(2):
        for leaf in leaves.values():
            leaf.grad = None
        loss, _ = step_fn.loss_fn(state.params, state.aux, batch,
                                  state.step + 1, times)
        loss.backward()
        runs.append((loss.detach(), {k: v.grad.detach().clone()
                                     for k, v in leaves.items()
                                     if v.grad is not None}))
    for leaf in leaves.values():
        leaf.grad = None
    (la, ga), (lb, gb) = runs
    if ga.keys() != gb.keys():
        fail("train step spread: the two runs gave gradients to different "
             "leaves")
    grads = {}
    for k in ga:
        diff = float((ga[k] - gb[k]).abs().max()) if ga[k].numel() else 0.0
        top = float(ga[k].abs().max()) if ga[k].numel() else 0.0
        grads[k] = (diff, diff / top if top > 0 else 0.0)
    same = torch.equal(la, lb) and all(torch.equal(ga[k], gb[k]) for k in ga)
    return {"loss": float((la - lb).abs()), "loss_value": float(la),
            "grads": grads, "identical": same}


def print_spread(phase: str, sp: dict) -> None:
    """Print `step_spread`'s result; fail unless both runs were the same
    bits."""
    print(f"train step run to run, phase {phase} (loss and gradients of the "
          "same s2 step twice from one state, max |a - b| and its share of "
          f"the leaf's max |grad|): bit-identical {sp['identical']}; loss "
          f"{sp['loss']:.3g}; " + "; ".join(
              f"{k} {v[0]:.3g} ({v[1]:.3g})" for k, v in sp["grads"].items()))
    if not sp["identical"]:
        fail(f"phase {phase}: one s2 step computed twice from one state "
             "gave different bits")


def lpips_precision(img, gt) -> dict:
    """LPIPS (the seeded fallback) of renders `img` (b, 3, h, w) against
    `gt`, and the gradient of its sum with respect to `img`, in TF32 and
    in float32 on the card. Each is computed twice, the forward under
    cuDNN's global TF32 flag off and the backward under it on, then the
    other way round: each pass sets its own precision, so the two must
    agree far closer than TF32 and float32 do (cuDNN's deterministic
    algorithms, which the scoped context asks for, made them the same
    bits on an H100). Also the forward and
    forward + backward times (CUDA events, mean of 3)."""
    import torch
    from dimo_tpu_torch.models.lpips import LPIPS, seeded_lpips_params
    from dimo_tpu_torch.utils.general import cudnn_tf32
    net = LPIPS(seeded_lpips_params(0)).to(img.device)

    def dist_grad(fwd_global: bool, bwd_global: bool):
        x = img.clone().requires_grad_(True)
        with cudnn_tf32(fwd_global):
            d = net(x, gt)
        with cudnn_tf32(bwd_global):
            d.sum().backward()
        return d.detach(), x.grad

    def fwd_bwd():
        x = img.clone().requires_grad_(True)
        net(x, gt).sum().backward()

    out = {}
    for tf32 in (True, False):
        net.tf32 = tf32
        (d, g), (d2, g2) = dist_grad(False, True), dist_grad(True, False)
        with torch.no_grad():
            fwd = cuda_ms(lambda: net(img, gt), 3, warmup=1)
        out["tf32" if tf32 else "float32"] = {
            "dist": d, "grad": g, "fwd_ms": fwd,
            "fwd_bwd_ms": cuda_ms(fwd_bwd, 3, warmup=1),
            "flags_swapped_dist": float((d - d2).abs().max()),
            "flags_swapped_grad": float((g - g2).abs().max())}
    a, b = out["tf32"], out["float32"]
    rel_d = float(((a["dist"] - b["dist"]).abs() / b["dist"].abs()).max())
    return {"dist_rel": rel_d,
            "dist_max": float((a["dist"] - b["dist"]).abs().max()),
            "grad_rel_l2": rel_l2(a["grad"], b["grad"]),
            "grad_max": float((a["grad"] - b["grad"]).abs().max()),
            "dist_f32": b["dist"].tolist(),
            **{f"{k}_{m}": v[m] for k, v in out.items()
               for m in ("fwd_ms", "fwd_bwd_ms", "flags_swapped_dist",
                         "flags_swapped_grad")}}


def profiled_step(step_fn, state, batch, logdir: str) -> dict:
    """One train step inside `diagnostics.profile_trace`, marked by a
    `train_step` annotation that ends after a synchronize; the card's
    busy share of that window from the trace's kernel events, and the
    kernels that took the most device time."""
    import torch
    from dimo_tpu_torch.utils import diagnostics
    with diagnostics.profile_trace(logdir):
        with torch.profiler.record_function("train_step"):
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
    if not bool(torch.isfinite(m["loss"])) or int(m["nonfinite_grad"]):
        fail(f"profiled step: loss {float(m['loss'])}")
    return diagnostics.device_busy_share(
        os.path.join(logdir, diagnostics.TRACE_FILE), "train_step")


class Interrupted(Exception):
    """Raised by the trainer phase's logger to cut a run short."""


def stamp():
    """A CUDA event recorded on the current stream."""
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def ms_between(a, b) -> float:
    """Milliseconds on the card between two `stamp`s."""
    b.synchronize()
    return a.elapsed_time(b)


def free_cached() -> None:
    """Synchronize and return the cached blocks (between runs)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def trainer_phase(device, synth_kw: dict, opt_kw: dict, s1_iters: int,
                  s2_iters: int, snapshot_every: int, interrupt_at: tuple,
                  extra_steps=((299, 2), (449, 3)), lpips_fn=None) -> dict:
    """The two-stage trainer through `Trainer.train_dynamic`: a first run
    cut at `interrupt_at` (stage, step), a fresh Trainer that resumes from
    the last snapshot and finishes, the final checkpoint read back, then
    `extra_steps` = ((step to set, steps to take), ...) through
    `train_step_once` at the later resolutions, every step with
    `lpips_fn`. Asserts every event of the cadence from the trainer's
    state; returns counts and timings."""
    import torch
    from dimo_tpu_torch.io.synthetic import make_synthetic_videos
    from dimo_tpu_torch.models import gaussians as G
    from dimo_tpu_torch.presets import tiny_synthetic_opt
    from dimo_tpu_torch.train.loop import Trainer, render_resolution_for_step

    t0 = time.time()
    images, masks, meta = make_synthetic_videos(device=device, **synth_kw)
    synth_s = time.time() - t0
    if not (masks.max() > 200 and images.std() > 10):
        fail("trainer: the synthetic videos are blank")
    root = tempfile.mkdtemp(prefix="dimo_smoke_")
    try:
        opt = tiny_synthetic_opt(save_path=os.path.join(root, "run"), **opt_kw)
        snap = os.path.join(root, "snap")
        num_cpts = int(opt.num_cpts)
        bs = int(opt.batch_size)
        b = (min(2 * bs, len(meta["input_videos"]))
             * min(bs, int(opt.num_views)) * min(bs, int(opt.num_frames)))
        log = []          # (stage, step, resolution, loss, skipped, n_active,
        #                    max opacity, stamp)

        def log_fn(stage, step, m, trainer):
            log.append((stage, step, render_resolution_for_step(step),
                        float(m["loss"]), int(m["nonfinite_grad"]),
                        int(G.num_active(trainer.state.aux)),
                        float(G.get_opacity(trainer.state.params)
                              .detach().max()),
                        stamp(), float(m["lpips"])))
            if (stage, step) == interrupt_at and trainer is first:
                raise Interrupted

        t0 = time.time()
        first = Trainer(opt, images, masks, meta, log_fn=log_fn,
                        device=device)
        start = stamp()
        try:
            first.train_dynamic(s1_iters, s2_iters,
                                snapshot_every=snapshot_every,
                                snapshot_dir=snap, lpips_fn=lpips_fn)
            fail("trainer: the first run was not interrupted")
        except Interrupted:
            pass
        cut = len(log)
        s1 = [e for e in log if e[0] == "s1"]
        n_at = {e[1]: e[5] for e in s1}       # n_active as step's log saw it
        fps, d0 = int(opt.FPS_iter), int(opt.densification_interval)
        reset = int(opt.opacity_reset_interval)
        # a densify that adds Gaussians (logged by the step after it)
        if not n_at[d0 + 1] > n_at[d0] == num_cpts:
            fail(f"trainer: densify at {d0} did not add Gaussians "
                 f"({n_at[d0]} -> {n_at[d0 + 1]})")
        op = {e[1]: e[6] for e in s1}
        if not (op[reset] > 0.02 and op[reset + 1] < 0.02):
            fail(f"trainer: opacity reset at {reset}: max opacity "
                 f"{op[reset]} -> {op[reset + 1]}")
        if not (n_at[fps] > num_cpts >= n_at[fps + 1]):
            fail(f"trainer: FPS anneal at {fps}: {n_at[fps]} -> "
                 f"{n_at[fps + 1]}, wanted > {num_cpts} -> <= {num_cpts}")
        for name in ("point_cloud.ply",
                     f"point_cloud_{int(opt.save_inter)}.ply",
                     "timenet.pth", "latent_codes.npz"):
            if not os.path.exists(os.path.join(opt.save_path, "s1", name)):
                fail(f"trainer: s1 checkpoint file {name} is missing")
        # finish_s1's prune -> the control points of stage 2
        k = int(first.state.aux.c_active.sum())
        n_s2 = -(-k * int(opt.num_pts_per_cpt) // 2048) * 2048
        if not (0 < k <= n_at[s1_iters] and first.stage == "s2"
                and first.mcfg.capacity == n_s2
                and first.state.params.xyz.shape[0] == n_s2):
            fail(f"trainer: s1 -> s2: {k} control points of "
                 f"{n_at[s1_iters]}, capacity {first.mcfg.capacity}")
        traj = first.cpts_s1.shape
        if traj != (len(meta["input_videos"]), int(opt.num_frames),
                    first.mcfg.cpt_capacity, 3):
            fail(f"trainer: cached trajectories of shape {traj}")
        if first.peek_snapshot_phase(snap) != "s2":
            fail("trainer: no s2 snapshot was left by the interrupted run")

        # a fresh Trainer resumes from the last snapshot and finishes
        done = (interrupt_at[1] - 1) // snapshot_every * snapshot_every
        second = Trainer(opt, images, masks, meta, log_fn=log_fn,
                         device=device)
        second.train_dynamic(s1_iters, s2_iters,
                             snapshot_every=snapshot_every, snapshot_dir=snap,
                             lpips_fn=lpips_fn)
        resumed = [(e[0], e[1]) for e in log[cut:]]
        if resumed != [("s2", i) for i in range(done + 1, s2_iters + 1)]:
            fail(f"trainer: resumed run took steps {resumed}, expected s2 "
                 f"{done + 1}..{s2_iters}")
        if second.peek_snapshot_phase(snap) is not None:
            fail("trainer: the finished run left its snapshot")
        s2 = [e for e in log if e[0] == "s2"]
        prune_at = int(opt.densification_interval_s2)
        pruned = {e[1]: e[5] for e in log[cut:]}
        n_after_ag = k * int(opt.num_pts_per_cpt)
        if not (s2[0][5] == n_after_ag
                and 0 < pruned[prune_at + 1] < n_after_ag):
            fail(f"trainer: s2 prune at {prune_at}: {n_after_ag} -> "
                 f"{pruned[prune_at + 1]}")
        n_final = int(G.num_active(second.state.aux))

        # the final s2 checkpoint, read back
        third = Trainer(opt, images, masks, meta, device=device)
        third.load_checkpoint("s2")
        if (int(G.num_active(third.state.aux)) != n_final
                or int(third.state.aux.c_active.sum()) != k
                or not torch.equal(
                    third.state.params.xyz[third.state.aux.active],
                    second.state.params.xyz[second.state.aux.active])):
            fail("trainer: the s2 checkpoint does not read back")

        # s2 steps at the later resolutions, through train_step_once
        for at, count in extra_steps:
            second.step = at
            for _ in range(count):
                second.train_step_once(lpips_fn)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    bad = [(e[0], e[1]) for e in log if not (e[3] == e[3] and abs(e[3]) <
                                             float("inf")) or e[4]]
    if bad:
        fail(f"trainer: non-finite loss or skipped step at {bad}")
    no_lpips = [(e[0], e[1]) for e in log if (e[8] > 0) != (lpips_fn is not None)]
    if no_lpips:
        fail(f"trainer: the LPIPS term is {'0' if lpips_fn else 'on'} at "
             f"{no_lpips}")
    head = sum(e[3] for e in s1[:5]) / 5
    tail = sum(e[3] for e in s1[-5:]) / 5
    if not tail < head:
        fail(f"trainer: s1 loss did not fall ({head} -> {tail})")
    per = {}
    stamps = [start] + [e[7] for e in log]
    for prev, e in zip(stamps, log):
        per.setdefault((e[0], e[2]), []).append(ms_between(prev, e[7]))
    stage_s = {st: sum(sum(v) for (s_, _), v in per.items() if s_ == st) / 1e3
               for st in ("s1", "s2")}
    return {"steps": len(log),
            "s2_steps": sum(1 for e in log if e[0] == "s2"),
            "renders_per_step": b, "k": k, "n_s2": n_after_ag,
            "n_final": n_final, "n_at": n_at, "synth_s": synth_s,
            "wall_s": wall_s, "stage_s": stage_s,
            "ms_per_step": {f"{st}@{res}": (sum(v) / len(v), len(v))
                            for (st, res), v in per.items()},
            "loss_s1": (head, tail), "loss_s2_last": log[-1][3],
            "losses_s1": [round(e[3], 1) for e in s1],
            "lpips_s1": (s1[0][8], s1[-1][8]), "lpips_s2_last": log[-1][8],
            "resumed_at": done + 1}


def twin_trainer_phase(device, synth_kw: dict, opt_kw: dict, s1_iters: int,
                       s2_iters: int, lpips_fn=None) -> dict:
    """Phase 7b: one cut `Trainer.train_dynamic` (no snapshots) run twice,
    each run by a fresh Trainer from the same seed and videos, the second
    after the first is freed. Returns both runs' step losses, the first
    (stage, step) whose losses differ, the active Gaussians of each run,
    and `diagnostics.fingerprint_diff` of the two runs' parameters, Adam
    moments and checkpoint files ({} when they are the same bits)."""
    import torch
    from dimo_tpu_torch.io.synthetic import make_synthetic_videos
    from dimo_tpu_torch.models import gaussians as G
    from dimo_tpu_torch.presets import tiny_synthetic_opt
    from dimo_tpu_torch.train.loop import Trainer
    from dimo_tpu_torch.utils import diagnostics

    images, masks, meta = make_synthetic_videos(device=device, **synth_kw)
    root = tempfile.mkdtemp(prefix="dimo_twin_")
    runs = []
    t0 = time.time()
    try:
        for r in range(2):
            opt = tiny_synthetic_opt(save_path=os.path.join(root, f"run{r}"),
                                     **opt_kw)
            log = []
            tr = Trainer(opt, images, masks, meta, device=device,
                         log_fn=lambda st, step, m, trainer: log.append(
                             (st, step, float(m["loss"]))))
            tr.train_dynamic(s1_iters, s2_iters, lpips_fn=lpips_fn)
            runs.append((log, diagnostics.run_fingerprint(tr),
                         int(G.num_active(tr.state.aux))))
            del tr
            if torch.device(device).type == "cuda":
                free_cached()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (la, fa, na), (lb, fb, nb) = runs
    first = next(((a[0], a[1]) for a, b in zip(la, lb) if a != b), None)
    if len(la) != len(lb) and first is None:
        first = ("steps", min(len(la), len(lb)))
    return {"steps": len(la), "losses": (la, lb), "first_diff": first,
            "n_active": (na, nb), "diff": diagnostics.fingerprint_diff(fa, fb),
            "files": len(fa["files"]), "stage": fa["counters"][0],
            "wall_s": time.time() - t0}


def determinism_probe(dev) -> None:
    """`--phase determinism`, a development run that fails nothing: the
    spread of one flagship s2 step computed twice (phase 6's step, then
    6b's with LPIPS on), the LPIPS input gradient and SSIM's gradient each
    computed twice, and phase 7b's twin trainers, all printed. It calls
    only entry points that older trees of the port have too, so a
    checkout of an older commit with this script copied in shows how that
    tree behaves."""
    import torch
    from dimo_tpu_torch.models.lpips import get_lpips, random_init_lpips
    from dimo_tpu_torch.ops import image_losses as L
    from dimo_tpu_torch.scenes import flagship_scene
    from dimo_tpu_torch.train.step import (LossConfig, init_state,
                                           make_train_step)
    cfg, params, aux, _ = flagship_scene(device=dev)
    n_m, n_v, n_f = TRAIN_SHAPE
    lcfg = LossConfig()
    state = init_state(params, aux, step=TRAIN_START - 1)
    batch = train_batch(params, TRAIN_SHAPE, WIDTH, dev, seed=0)
    lpips_fn = random_init_lpips(0, dev)
    for name, lp in (("6 (LPIPS off)", None), ("6b (LPIPS on)", lpips_fn)):
        fn = make_train_step(cfg, lcfg, "s2", WIDTH, HEIGHT, n_m, n_v, n_f,
                             capacity=CAPACITY, lpips_fn=lp,
                             use_guidance=True)
        sp = step_spread(fn, state, batch, lcfg)
        print(f"step_spread phase {name}: loss {sp['loss']:.3g}; " + "; ".join(
            f"{k} {v[0]:.3g} ({v[1]:.3g})" for k, v in sp["grads"].items()))
    gen = torch.Generator().manual_seed(3)
    img = torch.rand((4, 3, WIDTH, HEIGHT), generator=gen).to(dev)
    gt = torch.rand((4, 3, WIDTH, HEIGHT), generator=gen).to(dev)
    for name, f in (("LPIPS", lambda x: torch.sum(lpips_fn(x, gt))),
                    ("SSIM", lambda x: L.ssim(x.permute(0, 2, 3, 1),
                                              gt.permute(0, 2, 3, 1)))):
        gs = []
        for _ in range(2):
            x = img.clone().requires_grad_(True)
            f(x).backward()
            gs.append(x.grad)
        print(f"{name} input gradient twice: bit-identical "
              f"{torch.equal(*gs)}, max |a - b| "
              f"{float((gs[0] - gs[1]).abs().max()):.3g}")
    del state, batch, params, aux
    free_cached()
    tw = twin_trainer_phase(
        dev, dict(num_motions=4, num_views=3, num_frames=5, ref_size=512,
                  n_gauss=60, seed=0), TRAINER_OPT, *TWIN_ITERS,
        lpips_fn=get_lpips("weights/lpips_vgg.npz", fallback="random",
                           device=dev))
    print_twin(tw)


def scatter_timing(dev) -> dict:
    """`--phase timing`, a development run: the graph and loop ms of K4
    and K6 at the LBS shape (the flagship's KNN indices), of the row
    scatter at the flagship frame's strip lists (K3's slot gradients of a
    seeded cotangent), LPIPS's forward and backward of 16 renders at 512^2
    in calls of 4 and of 16 (CUDA events), and the s2 step's ms (phase
    6's shape, LPIPS off and on; one warm-up, then TIMING_STEPS each,
    host clock). It calls
    only entry points that older trees of the port have too, so a checkout
    of the commit before the fixed-order scatters, with this script copied
    in, gives the atomic designs' times to put beside these (runs in
    turns, each its own process)."""
    import torch
    from dimo_tpu_torch.models.lpips import random_init_lpips
    from dimo_tpu_torch.models.renderer import find_knn
    from dimo_tpu_torch.ops import smallgather as sg
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    from dimo_tpu_torch.ops.rasterizer import projection, strips
    from dimo_tpu_torch.ops.rasterizer import gather as rg
    from dimo_tpu_torch.ops.rasterizer.api import camera_tensors
    from dimo_tpu_torch.models import deform, gaussians as G
    from dimo_tpu_torch.scenes import flagship_scene
    from dimo_tpu_torch.train.step import (LossConfig, init_state,
                                           make_train_step)
    cfg, params, aux, cam = flagship_scene(device=dev)
    knn = find_knn(params, aux)
    nn_idx = knn[1].contiguous()
    m = params.c_xyz.shape[0]
    gen = torch.Generator().manual_seed(12)
    g4 = torch.randn((11,) + tuple(nn_idx.shape), generator=gen).to(dev)
    g6 = torch.randn(tuple(nn_idx.shape) + (11,), generator=gen).to(dev)
    with torch.no_grad():
        lat = G.sample_latent(params, 1)
        d_xyz, d_rot = params.timenet(params.c_xyz, 0.0, lat)
        means3d, rots = deform.lbs_blend(
            params.xyz, params.rotation, params.c_xyz, d_xyz, d_rot,
            G.get_c_radius(params), knn[1], knn[0])
        wv, fp, cp = camera_tensors(cam, dev)
        pr = projection.project(
            means3d, G.get_scaling(params, "s2"), rots, G.get_opacity(params),
            G.get_features(params), wv, fp, cp, float(cam.tan_fovx),
            float(cam.tan_fovy), WIDTH, HEIGHT, valid=aux.active)
        lists = strips.build_strip_lists(pr.mean2d, pr.cull_radius, pr.depth,
                                         pr.in_frustum, HEIGHT, WIDTH,
                                         CAPACITY)
        table = strips.coef_table(pr.mean2d, pr.conic, G.get_opacity(params),
                                  pr.color, pr.depth, pr.normal, HEIGHT, WIDTH)
        out = cs.composite_strips(table, lists.idx, lists.count, HEIGHT, WIDTH)
        gout = torch.randn(out.shape, generator=gen).to(dev)
        dslot = cs.composite_strips_bwd(table, lists.idx, lists.count,
                                        out[cs.OUT_CH], gout)
    rows = table.shape[0]
    fns = {"k4": lambda: sg.gather_small_cols_bwd(g4, nn_idx, m),
           "k6": lambda: sg.gather_small_bwd(g6, nn_idx, m),
           "row_scatter": lambda: rg.gather_rows_bwd(dslot, lists.idx, rows)}
    res = {}
    for name, fn in fns.items():
        res[f"{name}_graph_ms"] = graph_ms(fn, 200 if name != "row_scatter"
                                           else 50)
        res[f"{name}_ms"] = cuda_ms(fn, 200 if name != "row_scatter" else 50)
    # LPIPS's forward and backward on the step's 16 renders at 512^2, in
    # calls of 4 (a motion's) and of 16
    net = random_init_lpips(0, dev)
    img = torch.rand((16, 3, WIDTH, HEIGHT), generator=gen).to(dev)
    gt = torch.rand((16, 3, WIDTH, HEIGHT), generator=gen).to(dev)
    for per in (4, 16):
        def lp():
            x = img.clone().requires_grad_(True)
            sum(net(x[i:i + per], gt[i:i + per]).sum()
                for i in range(0, 16, per)).backward()
        res[f"lpips_{16 // per}x{per}_ms"] = cuda_ms(lp, 5, warmup=1)
    del img, gt
    n_m, n_v, n_f = TRAIN_SHAPE
    lcfg = LossConfig()
    state = init_state(params, aux, step=TRAIN_START - 1)
    batch = train_batch(params, TRAIN_SHAPE, WIDTH, dev, seed=0)
    for key, lp in (("step_ms", None), ("step_lpips_ms",
                                         random_init_lpips(0, dev))):
        fn = make_train_step(cfg, lcfg, "s2", WIDTH, HEIGHT, n_m, n_v, n_f,
                             capacity=CAPACITY, lpips_fn=lp,
                             use_guidance=True)
        state, _ = fn(state, batch)
        times = []
        for _ in range(TIMING_STEPS):
            torch.cuda.synchronize()
            t0 = time.time()
            state, _ = fn(state, batch)
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        res[key] = times
    return res


def print_twin(tw: dict) -> None:
    print(f"twin trainers ({TWIN_ITERS[0]} s1 + {TWIN_ITERS[1]} s2 "
          f"iterations, {tw['steps']} steps, {tw['files']} checkpoint files, "
          f"{tw['wall_s']:.1f} s): first step whose losses differ "
          f"{tw['first_diff']}; active Gaussians {tw['n_active']}; "
          f"differences {tw['diff'] or 'none: bit-identical'}")
    print("twin trainer losses: " + "; ".join(
        f"{a[0]} {a[1]}: {a[2]!r} / {b[2]!r}"
        for a, b in zip(*tw["losses"])))


def launch_counts() -> dict:
    """Every kernel's launch counter, by the names of the kernels line."""
    from dimo_tpu_torch.ops import smallgather as sg
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    from dimo_tpu_torch.ops.rasterizer import gather as rg
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    from dimo_tpu_torch.ops.rasterizer import windowdma as wd
    return {"K1 ch7": cs.launches["ch7"], "K1 ch3": cs.launches["ch3"],
            "K1 ch4": cs.launches["ch4"], "K2": sg.launches,
            "K3": cs.launches["bwd"], "K4": sg.bwd_launches,
            "K5": sg.rows_launches, "K6": sg.rows_bwd_launches,
            "K7": wd.launches, "K8 ch7": ct.launches["ch7"],
            "K8 ch4": ct.launches["ch4"], "K8 ch3": ct.launches["ch3"],
            "K9": ct.launches["bwd"], "row scatter": rg.launches}


def zero_launch_counts() -> None:
    from dimo_tpu_torch.ops import smallgather as sg
    from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
    from dimo_tpu_torch.ops.rasterizer import gather as rg
    from dimo_tpu_torch.ops.rasterizer import composite_tiles as ct
    from dimo_tpu_torch.ops.rasterizer import windowdma as wd
    cs.launches = dict.fromkeys(cs.launches, 0)
    ct.launches = dict.fromkeys(ct.launches, 0)
    sg.launches = sg.bwd_launches = sg.rows_launches = sg.rows_bwd_launches = 0
    wd.launches = rg.launches = 0


def frames_close(got, ref, what: str) -> int:
    """uint8 frames (H, W, 3): within 1 LSB + 1e-4 except on at most
    max(2, 2e-4 H W) pixels of a frame, where an entry's alpha may flip at
    the 1/255 cut (`tests/torch_parity.py::assert_close_except_cut_flips`).
    Returns the number of such pixels over all frames."""
    import numpy as np
    tol = 1.0 / 255.0 + 1e-4
    flips = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape:
            fail(f"{what} frame {i}: shape {g.shape} vs {r.shape}")
        err = np.abs(g.astype(np.float64) - r.astype(np.float64)) / 255.0
        bad = int((err > tol).any(axis=-1).sum())
        limit = max(2, int(2e-4 * err.shape[0] * err.shape[1]))
        if bad > limit or float(err.max()) > 2.0 / 255.0 + tol:
            fail(f"{what} frame {i}: {bad} px over 1 LSB (limit {limit}), "
                 f"max |err| {float(err.max()) * 255:.2f} LSB")
        flips += bad
    return flips


def motion_dirs(folder: str, n: int) -> str:
    """A folder of n empty motion directories, motion_00.. (what the test
    CLI's `load_info` lists when there is no info.json)."""
    for m in range(n):
        os.makedirs(os.path.join(folder, f"motion_{m:02d}"), exist_ok=True)
    return folder


def write_checkpoint(root: str, scene: tuple, n_motions: int, device) -> str:
    """Save `scene` (cfg, params, aux, camera) as an s2 checkpoint under
    root/run through `Trainer.save_checkpoint`, beside a folder of
    `n_motions` empty motion directories (the test CLI's input_folder).
    Returns the data folder."""
    import numpy as np
    from dimo_tpu_torch.presets import tiny_synthetic_opt
    from dimo_tpu_torch.train.loop import Trainer
    from dimo_tpu_torch.train.step import init_state
    data = motion_dirs(os.path.join(root, "data"), n_motions)
    names = sorted(os.listdir(data))
    tiny = np.zeros((n_motions, 1, 1, 8, 8, 3), np.uint8)
    tr = Trainer(tiny_synthetic_opt(save_path=os.path.join(root, "run"),
                                    num_views=1, num_frames=1),
                 tiny, tiny[..., 0], {"input_videos": names, "azimuths": [0]},
                 device=device)
    cfg, params, aux, _ = scene
    tr.mcfg, tr.state, tr.stage = cfg, init_state(params, aux), "s2"
    tr.save_checkpoint("s2")
    return data


def small_sequences(root: str, device) -> dict:
    """`render_sequence` of a small scene (2,048 Gaussians, 32 control
    points, latent 8) from one s2 checkpoint on the card and on the CPU,
    orbit camera, 5 frames at 100^2 and 160^2 (sides that are not powers
    of two; 100 is not a multiple of the 32-px strip). Returns the largest
    error in LSB and the flip pixels."""
    import numpy as np
    from dimo_tpu_torch import test_modes
    from dimo_tpu_torch.presets import tiny_synthetic_opt
    from dimo_tpu_torch.scenes import flagship_scene, move_timenet
    from dimo_tpu_torch.train.loop import Trainer
    scene = flagship_scene(2048, 32, 8, seed=3, device="cpu")
    move_timenet(scene[1], 5)
    write_checkpoint(root, scene, 2, "cpu")
    tiny = np.zeros((2, 1, 1, 8, 8, 3), np.uint8)
    meta = {"input_videos": ["motion_00", "motion_01"], "azimuths": [0]}
    out = {}
    for side in (100, 160):
        seqs = []
        for where in (device, "cpu"):
            opt = tiny_synthetic_opt(
                save_path=os.path.join(root, "run"), W=side, H=side,
                num_views=1, num_frames=5, latent_code_dim=8, fovy=33.9,
                tile_capacity=512)
            tr = Trainer(opt, tiny, tiny[..., 0], meta, device=where)
            tr.load_checkpoint("s2")
            seqs.append(np.stack(test_modes.render_sequence(tr, 1, "s2",
                                                            "circle")))
        flips = frames_close(seqs[0], seqs[1], f"render_sequence {side}^2 "
                             "card vs CPU")
        err = int(np.abs(seqs[0].astype(int) - seqs[1].astype(int)).max())
        if not seqs[1].std() > 10:
            fail(f"render_sequence {side}^2: blank frames")
        out[side] = (err, flips)
    free_cached()
    return out


def write_motion_pngs(folder: str, images, masks) -> None:
    """One motion's (V, F, S, S, 3) frames and (V, F, S, S) masks as RGBA
    PNGs at folder/motion_00/view_XX/FF.png, `load_videos`' layout."""
    import cv2
    import numpy as np
    for v in range(images.shape[0]):
        d = os.path.join(folder, "motion_00", f"view_{v:02d}")
        os.makedirs(d, exist_ok=True)
        for f in range(images.shape[1]):
            bgra = np.concatenate([images[v, f][..., ::-1],
                                   masks[v, f][..., None]], -1)
            cv2.imwrite(os.path.join(d, f"{f:02d}.png"), bgra)


def host_dataset(shape: tuple) -> tuple:
    """(images, masks, meta) of shape (M, V, F, S): a seeded random frame
    plus each frame's own offset, so that every frame differs from every
    other and a batch row shows which frame it holds."""
    import numpy as np
    m, v, f, side = shape
    rng = np.random.RandomState(0)
    base = rng.randint(0, 256, (side, side, 3)).astype(np.uint8)
    images = np.empty((m, v, f, side, side, 3), np.uint8)
    masks = np.empty((m, v, f, side, side), np.uint8)
    flat_i = images.reshape(-1, side, side, 3)
    flat_m = masks.reshape(-1, side, side)
    for i in range(flat_i.shape[0]):
        np.add(base, np.uint8(i % 251), out=flat_i[i])
        np.add(base[..., 0], np.uint8((7 * i) % 253), out=flat_m[i])
    meta = {"input_videos": [f"motion_{k:02d}" for k in range(m)],
            "azimuths": list(np.linspace(0, 360, v, endpoint=False)),
            "elevations": [0.0] * v}
    return images, masks, meta


def host_trainer(dev, data, save_path: str, device_data: str):
    """A Trainer on `data` with DIMO_DEVICE_DATA=device_data, holding the
    flagship s2 checkpoint under save_path, at s2 step HOST_START_STEP
    (the next renders at 512^2), its trajectories cached for the guidance
    loss."""
    from dimo_tpu_torch.presets import tiny_synthetic_opt
    from dimo_tpu_torch.train.loop import Trainer
    held = os.environ.get("DIMO_DEVICE_DATA")
    os.environ["DIMO_DEVICE_DATA"] = device_data
    try:
        m, v, f, side = data[0].shape[:4]
        opt = tiny_synthetic_opt(
            save_path=save_path, batch_size=2, num_views=v, num_frames=f,
            ref_size=side, W=WIDTH, H=HEIGHT, fovy=33.9, latent_code_dim=32,
            num_cpts=512, capacity_s1=8192, tile_capacity=CAPACITY)
        tr = Trainer(opt, *data, device=dev)
    finally:
        if held is None:
            os.environ.pop("DIMO_DEVICE_DATA")
        else:
            os.environ["DIMO_DEVICE_DATA"] = held
    tr.load_checkpoint("s2")
    tr.stage, tr.step = "s2", HOST_START_STEP
    tr.cache_s1_trajectories()
    return tr


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run_steps(tr, n: int, warmup: bool, check_rows=None) -> dict:
    """n train steps (after one more as a warm-up); ms per step (host
    clock, synchronized), ms per `sample_batch` (host clock), losses, and
    every batch's device GT kept for `check_rows` (read only after the
    steps, so no read of the card waits out a copy before the packer's
    next fill)."""
    held, kept, batch_ms = tr.sample_batch, [], []

    def sample():
        t0 = time.perf_counter()
        meta = tr._pending_meta
        out = held()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        kept.append((meta, out[0]["gt_image"], out[0]["gt_mask"]))
        return out

    tr.sample_batch = sample
    losses = []
    tr.log_fn = lambda s, st, m, trainer: losses.append(float(m["loss"]))
    try:
        if warmup:
            tr.train_step_once()
        sync(tr.device)
        t0 = time.perf_counter()
        for _ in range(n):
            tr.train_step_once()
        sync(tr.device)
        step_ms = (time.perf_counter() - t0) / n * 1e3
    finally:
        tr.sample_batch = held
    bad = check_rows(kept) if check_rows else 0
    return {"step_ms": step_ms, "batch_ms": batch_ms, "losses": losses,
            "bad_rows": bad}


def native_phase(dev, root: str) -> dict:
    """Phase 10a: the native library (which file loaded), the flagship's
    PLY through the C++ codec and the numpy one, then the s2 step on phase
    9's dataset shape kept on the host (the packer, page-locked slots,
    asynchronous copies) against the same steps through numpy's gather
    and with the dataset on the device, in turns, and
    `bench_train_torch.py`'s packer probe."""
    import numpy as np
    import torch
    import bench_train_torch
    from dimo_tpu_torch.io import native, ply
    from dimo_tpu_torch.scenes import flagship_scene
    t_phase = time.time()
    if not native.available():
        fail("phase 10a: the native library did not load")
    out = {"library": os.path.relpath(native.library_path(), os.path.dirname(
        os.path.abspath(__file__)))}
    scene = flagship_scene(device=dev)
    p = scene[1]
    cols = [p.xyz, p.features_dc, p.features_rest, p.opacity, p.scaling,
            p.rotation]
    cols = [c.detach().cpu().numpy() for c in cols]
    paths = {w: os.path.join(root, f"flagship_{w}.ply")
             for w in ("native", "numpy")}
    t0 = time.perf_counter()
    ply.save_gaussians(paths["native"], *cols)
    out["ply_write_native_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got_native = ply._read_ply(paths["native"])
    out["ply_read_native_ms"] = (time.perf_counter() - t0) * 1e3
    lib, native._LIB = native._LIB, None       # the numpy codec alone
    try:
        t0 = time.perf_counter()
        ply.save_gaussians(paths["numpy"], *cols)
        out["ply_write_numpy_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got_numpy = ply._read_ply(paths["native"])
        out["ply_read_numpy_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        native._LIB = lib
    with open(paths["native"], "rb") as fa, open(paths["numpy"], "rb") as fb:
        if fa.read() != fb.read():
            fail("phase 10a: the native and numpy PLY writers differ")
    if got_native.keys() != got_numpy.keys() or not all(
            np.array_equal(got_native[k], got_numpy[k]) for k in got_native):
        fail("phase 10a: the native and numpy PLY readers differ")
    if not np.array_equal(got_native["x"], cols[0][:, 0]):
        fail("phase 10a: the PLY round trip changed the positions")
    out["ply_gaussians"] = int(cols[0].shape[0])
    write_checkpoint(root, scene, HOST_DATA_SHAPE[0], dev)
    del scene, p, cols
    free_cached()

    t0 = time.time()
    data = host_dataset(HOST_DATA_SHAPE)
    out["dataset_bytes"] = int(data[0].nbytes + data[1].nbytes)
    out["dataset_s"] = time.time() - t0
    side = HOST_DATA_SHAPE[3]
    flat_i = data[0].reshape(-1, side, side, 3)
    flat_m = data[1].reshape(-1, side, side)

    def check_rows(kept) -> int:
        bad = 0
        for meta, gi, gm in kept:
            if meta is None:
                continue      # the first batch's meta was drawn inside
            if not (np.array_equal(gi.cpu().numpy(), flat_i[meta["flat"]])
                    and np.array_equal(gm.cpu().numpy(),
                                       flat_m[meta["flat"]])):
                bad += 1
        return bad

    save = os.path.join(root, "run")
    trainers, draws = {}, {}
    for route, dd in (("packer", "0"), ("numpy", "0"), ("device", "1")):
        tr = trainers[route] = host_trainer(dev, data, save, dd)
        if route == "numpy":
            tr._get_packer = lambda b: None    # numpy's gather on the host
        # the motions are drawn from the global np.random (the reference's
        # sampling): each route keeps its own stream, so all draw the same
        # batches in turns
        draws[route] = np.random.get_state()
        on_host = tr._dev_images is None
        if on_host != (route != "device"):
            fail(f"phase 10a: DIMO_DEVICE_DATA={dd} kept the dataset on the "
                 f"{'host' if on_host else 'device'}")
        out[route] = {"step_ms": [], "batch_ms": [], "losses": []}
    # the three routes in turns, the same batches on each
    for rep in range(2):
        for route, tr in trainers.items():
            zero_launch_counts()
            np.random.set_state(draws[route])
            r = run_steps(tr, HOST_STEPS, rep == 0, check_rows)
            draws[route] = np.random.get_state()
            got = launch_counts()
            renders = (HOST_STEPS + (rep == 0)) * 16
            if got["K1 ch7"] != renders or got["K3"] != renders \
                    or got["K2"] != renders or got["K4"] != renders:
                fail(f"phase 10a {route}: launches {got}, expected {renders}")
            o = out[route]
            o["launches"] = got
            o["step_ms"].append(r["step_ms"])
            o["batch_ms"] += r["batch_ms"]
            o["losses"] += r["losses"]
            if route != "device" and r["bad_rows"]:
                fail(f"phase 10a {route}: {r['bad_rows']} batches differ "
                     "from the flat gather of their frames")
    tr = trainers["packer"]
    if tr._packer is None:
        fail("phase 10a: the packer route did not use the packer")
    if trainers["numpy"]._packer is not None:
        fail("phase 10a: the numpy route used the packer")
    out["packer"]["pinned"] = bool(tr._packer.out_imgs[0].is_pinned())
    if not out["packer"]["pinned"]:
        fail("phase 10a: the packer's slots are not page-locked")
    del trainers, tr
    free_cached()
    ld = out["device"]["losses"]
    for route in ("packer", "numpy"):
        lh = out[route]["losses"]
        if (len(lh) != 2 * HOST_STEPS + 1 or lh[0] != ld[0]
                or not np.allclose(lh, ld, rtol=1e-4)):
            fail(f"phase 10a: {route}-route losses {lh} vs device-route {ld}")
    pk, npy = bench_train_torch.packer_probe(2, 2, dev)
    out["host_batch_packer_ms"], out["host_batch_numpy_ms"] = pk, npy
    out["wall_s"] = time.time() - t_phase
    return out


def parallel_phase(dev, root: str) -> dict:
    """Phase 10b: the Trainer with a one-rank NCCL mesh against a Trainer
    without one (the same batches, each step from one state), then
    two ranks sharing the card over gloo (`parallel/check.py::
    card_worker`): the flagship s2 step at data_parallel=2 against one
    rank, and the fps render sharded over both."""
    import json as _json
    import numpy as np
    import torch
    import torch.distributed as dist
    from dimo_tpu_torch.parallel import check
    from dimo_tpu_torch.parallel import mesh as mesh_mod
    t_phase = time.time()
    out = {}
    data = host_dataset((2, 2, 2, 128))
    save = os.path.join(root, "run")
    ref = host_trainer(dev, data, save, "1")
    if ref.mesh is not None:
        fail("phase 10b: a Trainer outside a group took a mesh")
    rdv = os.path.join(root, "nccl_rdv")
    if os.path.exists(rdv):
        os.remove(rdv)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0,
                            world_size=1)
    try:
        tr = host_trainer(dev, data, save, "1")
        if tr.mesh is not None:
            fail("phase 10b: a Trainer at data_parallel=1 took a mesh")
        # its steps are made with the one-rank mesh: every collective of
        # the data-parallel step runs over NCCL
        tr.mesh = mesh_mod.make_mesh(1, device=dev)
        tr._step_fns.clear()
        if dist.get_backend() != "nccl":
            fail("phase 10b: the one-rank group is not NCCL")
        log = []
        zero_launch_counts()
        for _ in range(2):
            check._step_both(tr, ref, log)
        out["nccl_world1"] = log
        out["nccl_launches"] = launch_counts()
    finally:
        dist.destroy_process_group()
    for s in log:
        if not np.isclose(s["dp_loss"], s["ref_loss"], rtol=1e-5, atol=0):
            fail(f"phase 10b: NCCL world 1 loss {s['dp_loss']} vs "
                 f"{s['ref_loss']}")
    del tr, ref
    free_cached()

    work = os.path.join(root, "ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    kw = {"device": "cuda", "shape": TRAIN_SHAPE, "res": WIDTH,
          "capacity": CAPACITY, "fps_size": WIDTH, "fps_capacity": 512,
          "fps_rounds": SP_FPS_ROUNDS}
    t0 = time.time()
    try:
        check.spawn(check.card_worker, PARALLEL_WORLD,
                    (os.path.join(work, "rdv"), work, kw), PARALLEL_TIMEOUT_S)
    except Exception as e:
        fail(f"phase 10b: the two ranks failed: {e!r}")
    out["ranks_s"] = time.time() - t0
    per_rank = TRAIN_SHAPE[0] * TRAIN_SHAPE[1] * TRAIN_SHAPE[2] // PARALLEL_WORLD
    ranks = []
    for r in range(PARALLEL_WORLD):
        with open(os.path.join(work, f"card_rank{r}.json")) as f:
            res = _json.load(f)
        ranks.append(res)
        if not np.isclose(res["loss"], res["ref_loss"], rtol=1e-5, atol=0):
            fail(f"phase 10b rank {r}: loss {res['loss']} vs data_parallel=1 "
                 f"{res['ref_loss']}")
        worst = max(res["grad_rel_l2"].values())
        if not worst <= 1e-3:
            fail(f"phase 10b rank {r}: gradient relative L2 by leaf "
                 f"{res['grad_rel_l2']}; the unsharded step's own spread "
                 f"{res['ref_spread_rel_l2']}")
        if not all(res["same_as_rank0"].values()) or res["nonfinite"]:
            fail(f"phase 10b rank {r}: parameters differ from rank 0's "
                 f"{res['same_as_rank0']} (non-finite {res['nonfinite']})")
        if res["launches"] != {"K1 ch7": per_rank, "K3": per_rank,
                               "K2": per_rank, "K4": per_rank}:
            fail(f"phase 10b rank {r}: launches {res['launches']}, expected "
                 f"{per_rank} each")
        if not (res["sp_ch3_equal"] and res["sp_ch7_equal"]):
            fail(f"phase 10b rank {r}: the sharded render differs "
                 f"(ch3 {res['sp_ch3_max_err']}, ch7 {res['sp_ch7_max_err']})")
        if res["fps_sp_k1_ch3"] != SP_FPS_ROUNDS:
            fail(f"phase 10b rank {r}: K1 ch3 {res['fps_sp_k1_ch3']} in "
                 f"{SP_FPS_ROUNDS} sharded renders")
    out["ranks"] = ranks
    out["wall_s"] = time.time() - t_phase
    return out


def quality_phase(dev, root: str) -> dict:
    """Phase 10c: `eval_quality_torch.py --fast --iters 30,20` on the card
    at its 256^2 shape, LPIPS on (the seeded fallback): the JSON keys, a
    finite PSNR, the scoring at the trainer's live capacity."""
    import math
    from dimo_tpu_torch import eval_quality
    t_phase = time.time()
    seen = {}
    score = eval_quality.score_psnr

    def scored(tr, images, capacity):
        seen.update(live=int(tr.tile_capacity), used=int(capacity))
        return score(tr, images, capacity)

    eval_quality.score_psnr = scored
    try:
        res = eval_quality.main(
            ["--fast", "--iters", QUALITY_ITERS,
             "--out", os.path.join(root, "eval_quality_fast.json"),
             "--run-dir", os.path.join(root, "eval_quality"),
             "--videos", os.path.join(root, "eval_quality_videos")],
            device=dev)
    finally:
        eval_quality.score_psnr = score
    want = {"psnr", "gate", "passed", "n_gaussians", "resolution", "motions",
            "iters", "train_seconds", "sec_per_step", "lpips",
            "eval_capacity", "videos_ok", "videos_error", "fast", "scale512"}
    if set(res) != want:
        fail(f"phase 10c: keys {sorted(res)}")
    if not math.isfinite(res["psnr"]) or res["gate"] != 26.0:
        fail(f"phase 10c: {res}")
    if seen.get("live") != res["eval_capacity"] or seen["used"] != seen["live"]:
        fail(f"phase 10c: scored at {seen}, reported {res['eval_capacity']}")
    if res["videos_ok"] is not True or res["videos_error"] is not None:
        fail(f"phase 10c: videos_ok {res['videos_ok']}, videos_error "
             f"{res['videos_error']}")
    res["wall_s"] = time.time() - t_phase
    return res


def check_track_video(vid, tracks, visibles, figsize, what: str) -> int:
    """One 3-D track video of phase 9: its shape, ink in every frame, and
    each visible control point's jet colour within 2 px of the pixel on
    which the port's projection (`viz._project_3d_tracks`) centres its
    marker. A point may be hidden by a marker drawn after it (farther
    first): one whose colour is missing is excused only if such a marker's
    centre lies within 4 px (twice the marker's radius). Returns how many
    points were excused."""
    import numpy as np
    from dimo_tpu_torch import viz
    f, n, _ = tracks.shape
    want = (f, int(round(figsize[1] * 100)), int(round(figsize[0] * 100)), 3)
    if vid.shape != want or vid.dtype != np.uint8:
        fail(f"{what}: 3-D track video {vid.shape} {vid.dtype}, expected "
             f"{want} uint8")
    ink = [int((fr < 250).any(-1).sum()) for fr in vid]
    if min(ink) == 0:
        fail(f"{what}: a 3-D track frame has no ink: {ink}")
    if visibles is None:
        visibles = np.ones((f, n), bool)
    col, row, depth = viz._project_3d_tracks(tracks, figsize)
    cx = np.floor(col + 0.5).astype(np.int64)
    cy = np.floor(row + 0.5).astype(np.int64)
    colors = viz._colormap_jet(n).astype(np.uint8)
    d = np.arange(-2, 3)
    excused = 0
    for fi in range(f):
        ys = np.clip(cy[fi][:, None, None] + d[None, :, None], 0, want[1] - 1)
        xs = np.clip(cx[fi][:, None, None] + d[None, None, :], 0, want[2] - 1)
        found = (vid[fi][ys, xs] == colors[:, None, None]).all(-1).any((1, 2))
        vis = np.flatnonzero(visibles[fi])
        rank = np.full(n, -1)
        rank[vis[np.argsort(-depth[fi, vis], kind="stable")]] = \
            np.arange(len(vis))
        for i in vis[~found[vis]]:
            later = rank > rank[i]
            if not (np.hypot(cx[fi] - cx[fi, i], cy[fi] - cy[fi, i])[later]
                    <= 4).any():
                fail(f"{what}: frame {fi} control point {i} at "
                     f"({col[fi, i]:.2f}, {row[fi, i]:.2f}) has no pixel of "
                     f"its colour {colors[i].tolist()} within 2 px")
            excused += 1
    return excused


def test_modes_phase(dev, root: str) -> dict:
    """Phase 9: the test CLI's body on the flagship checkpoint in every mode,
    at `configs/test_config.yaml`'s widths, then the train CLI's body on
    synthetic videos and its train_dynamic=False route. Launch counters
    zeroed before and read after each mode; returns timings and counts."""
    import importlib.util
    import numpy as np
    import torch
    from dimo_tpu_torch import cli, test_modes, viz
    from dimo_tpu_torch.io import dataset as dataset_io
    from dimo_tpu_torch.io.config import load_config
    from dimo_tpu_torch.io.synthetic import make_synthetic_videos
    from dimo_tpu_torch.scenes import flagship_scene, move_timenet
    from dimo_tpu_torch.train import optim
    from dimo_tpu_torch.train.step import init_state, make_train_step
    from dimo_tpu_torch.train.loop import Trainer, loss_config_from_opt
    t_phase = time.time()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    here = os.path.dirname(os.path.abspath(__file__))
    test_cfg = os.path.join(here, "configs", "test_config.yaml")
    train_cfg = os.path.join(here, "configs", "train_config.yaml")
    opt = load_config(test_cfg, [])
    n_v, n_f, side = int(opt.num_views), int(opt.num_frames), int(opt.W)
    bs, ref = int(opt.batch_size), int(opt.ref_size)

    # the card-vs-CPU sequences first, at a small size
    small = small_sequences(os.path.join(root, "small"), dev)

    # the flagship checkpoint: 100k Gaussians, 512 control points, 4 latents
    scene = flagship_scene(device=dev)
    move_timenet(scene[1], 1)
    data = write_checkpoint(root, scene, PHASE9_MOTIONS, dev)
    del scene
    emb_path = os.path.join(root, "text_emb.npy")
    np.save(emb_path, np.random.RandomState(0).randn(1, 768).astype(np.float32))

    # the unseen motion: synthetic, made on the card, through PNGs
    t0 = time.time()
    m_img, m_msk, _ = make_synthetic_videos(
        num_motions=1, num_views=n_v, num_frames=n_f, ref_size=ref, seed=7,
        fovy_deg=float(opt.fovy), radius=float(opt.radius), device=dev)
    motion_dir = os.path.join(root, "motion")
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "imageio", "matplotlib", "PIL")}
    real = {"write_video": viz.write_video,
            "plot_3d_tracks": viz.plot_3d_tracks,
            "to_u8": test_modes._to_u8,
            "render_sequence": test_modes.render_sequence,
            "run_test_motion": test_modes.run_test_motion,
            "run_test_unaligned_motion": test_modes.run_test_unaligned_motion,
            "upload": Trainer._upload_dataset}
    if not (have["cv2"] and have["PIL"]):
        fail(f"phase 9 draws trajectories with OpenCV and PIL: {have}")
    write_motion_pngs(motion_dir, m_img[0], m_msk[0])
    loaded = dataset_io.load_videos(motion_dir, ["motion_00"], n_v, n_f, ref)
    if not (np.array_equal(loaded[0][0], m_img[0]) and int(np.abs(
            loaded[1][0].astype(int) - m_msk[0].astype(int)).max()) <= 1):
        fail("the synthetic motion does not read back through load_videos")
    motion_s = time.time() - t0

    # the real writers, each call noted; the 3-D track videos timed and
    # checked
    videos, frame_stats, seq_ms, ft, uploads = {}, {"n": 0}, [], {}, {}
    plots_3d = []
    mode_now = ["setup"]

    def write_video(path, frames, fps=8):
        frames = [np.asarray(f) for f in frames]
        videos[os.path.basename(path)] = (len(frames), frames[0].shape)
        real["write_video"](path, frames, fps)

    def plot_3d_tracks(tracks, visibles=None, tracks_leave_trace=8,
                       figsize=(5, 5)):
        t0 = time.perf_counter()
        vid = real["plot_3d_tracks"](tracks, visibles, tracks_leave_trace,
                                     figsize)
        ms = (time.perf_counter() - t0) * 1e3 / len(tracks)
        hidden = check_track_video(vid, tracks, visibles, figsize,
                                   f"phase 9 {mode_now[0]}")
        plots_3d.append((mode_now[0], tracks.shape, ms, hidden))
        return vid

    def to_u8(img):
        if not bool(torch.isfinite(img).all()):
            fail(f"phase 9 {mode_now[0]}: a frame is not finite")
        frame_stats["n"] += 1
        return real["to_u8"](img)

    def render_sequence(tr, latent_index, stage, render_type="fixed",
                        render_fn=None):
        start = stamp()
        frames = real["render_sequence"](tr, latent_index, stage, render_type,
                                         render_fn)
        end = stamp()
        seq_ms.append((mode_now[0], int(tr.opt.W), len(frames),
                       ms_between(start, end)))
        flagship = not mode_now[0].startswith("train")
        for i, f in enumerate(frames):
            if flagship and stage >= "s2" and not (150 <= f.mean() <= 245
                                                   and f.std() > 10):
                fail(f"phase 9 {mode_now[0]}: frame {i} is not an object on "
                     f"white (mean {f.mean():.1f}, std {f.std():.1f})")
        return frames

    def fit_wrapper(name, iters_kw, allowed, timenet_moves):
        """The CLI's fine-tuning mode at a cut depth, with a CUDA-event
        stamp per step; checks which leaves moved."""
        def run(tr, images, masks, lpips_fn=None, log_fn=None, **_):
            tr.load_checkpoint(tr.opt.test_stage)
            before = {k: v.detach().clone()
                      for k, v in optim.named_leaves(tr.state.params).items()}
            stamps = [stamp()]
            losses = []

            def log(it, m):
                stamps.append(stamp())
                losses.append((float(m["loss"]), float(m["lpips"])))
                if log_fn is not None:
                    log_fn(it, m)
            out = real[name](tr, images, masks, lpips_fn=lpips_fn,
                             log_fn=log, **iters_kw)
            torch.cuda.synchronize()
            after = optim.named_leaves(tr.state.params)
            moved = sorted(k for k, v in before.items()
                           if v.shape != after[k].shape
                           or not torch.equal(v, after[k].detach()))
            if not ("latent.codes" in moved and all(allowed(k) for k in moved)
                    and any(k.startswith("timenet.") for k in moved)
                    == timenet_moves):
                fail(f"phase 9 {name}: leaves that moved {moved}")
            bad = [x for x in losses if not (np.isfinite(x[0]) and x[1] > 0)]
            if bad or not np.isfinite(float(out["loss"])):
                fail(f"phase 9 {name}: losses {losses}")
            ft[name] = {"moved": moved, "losses": losses,
                        "step_ms": [ms_between(a, b)
                                    for a, b in zip(stamps, stamps[1:])],
                        "tr": tr, "data": (images, masks), "lpips": lpips_fn}
            return out
        return run

    def upload(tr):
        """`Trainer`'s upload of the CLI's dataset, timed on the host clock
        between two synchronizes."""
        torch.cuda.synchronize()
        t0 = time.time()
        real["upload"](tr)
        torch.cuda.synchronize()
        uploads[mode_now[0]] = {
            "bytes": int(tr.images.nbytes + tr.masks.nbytes),
            "s": time.time() - t0, "on_card": tr._dev_images is not None}

    patches = [(Trainer, "_upload_dataset", upload),
               (viz, "write_video", write_video),
               (viz, "plot_3d_tracks", plot_3d_tracks),
               (test_modes, "_to_u8", to_u8),
               (test_modes, "render_sequence", render_sequence),
               (test_modes, "run_test_motion", fit_wrapper(
                   "run_test_motion", {"iters": FT_ITERS},
                   lambda k: k == "latent.codes", False)),
               (test_modes, "run_test_unaligned_motion", fit_wrapper(
                   "run_test_unaligned_motion",
                   {"iters_a": FT_ITERS_A, "iters_b": FT_ITERS_B},
                   lambda k: k.startswith(("latent.", "timenet.")), True))]
    print("phase 9 writers, all real: mp4s through "
          + ("imageio, else OpenCV" if have["imageio"]
             else "OpenCV (no imageio)")
          + ", trajectories through OpenCV and PIL, plot_3d_tracks through "
          + ("matplotlib" if have["matplotlib"] else
             "viz._plot_3d_tracks_raster (no matplotlib)"))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    base = ["--config", test_cfg, f"input_folder={data}",
            f"save_path={os.path.join(root, 'run')}",
            f"video_save_dir={os.path.join(root, 'videos')}"]
    M, B = PHASE9_MOTIONS, (1 + min(bs, n_v - 1)) * min(bs, n_f)
    zero = dict.fromkeys(launch_counts(), 0)

    def want(**kw):
        return {**zero, **{k.replace("_", " "): v for k, v in kw.items()}}

    modes = [
        ("default", [], want(K1_ch7=2 * n_f * M, K2=n_f * M)),
        ("interpolation", ["test_interpolation=True"],
         want(K1_ch7=2 * n_f, K2=n_f)),
        ("paper", ["test_paper=True"], want(K1_ch7=3 * n_f * M, K2=2 * n_f * M)),
        ("fps", ["test_fps=True"], want(K1_ch3=1 + FPS_HARNESS_ROUNDS,
                                        K2=1 + FPS_HARNESS_ROUNDS)),
        ("language", ["test_language=True", f"test_text_emb={emb_path}",
                      "test_text_prompt=a person waves"],
         want(K1_ch7=2 * n_f, K2=n_f)),
        ("test_motion", ["test_motion=True", f"test_motion_data={motion_dir}"],
         want(K1_ch7=B * FT_ITERS + 3 * n_f, K2=B * FT_ITERS + 2 * n_f,
              K3=B * FT_ITERS, K4=B * FT_ITERS, row_scatter=B * FT_ITERS)),
        ("test_unaligned_motion", ["test_unaligned_motion=True",
                                   f"test_unaligned_motion_data={motion_dir}"],
         want(K1_ch7=B * (FT_ITERS_A + FT_ITERS_B) + n_f,
              K2=B * FT_ITERS_B + n_f, K3=B * (FT_ITERS_A + FT_ITERS_B),
              K4=B * FT_ITERS_B,
              row_scatter=B * (FT_ITERS_A + FT_ITERS_B)))]
    walls, launches, results = {}, {}, {}
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        for name, flags, expect in modes:
            mode_now[0] = name
            free_cached()
            zero_launch_counts()
            t0 = time.time()
            results[name] = cli.test_main(base + flags, device=dev)
            torch.cuda.synchronize()
            walls[name] = time.time() - t0
            launches[name] = launch_counts()
            if launches[name] != expect:
                fail(f"phase 9 {name}: launches {launches[name]}, expected "
                     f"{expect}")
            print(f"phase 9 {name}: {walls[name]:.2f} s, launches "
                  + json.dumps({k: v for k, v in launches[name].items() if v}))

        # fine-tuning step time by resolution (the fit's 128 / 256 / 512)
        fit = ft["run_test_motion"]
        tr = fit["tr"]
        assemble = test_modes._device_batch_sampler(
            tr, *fit["data"], tr.state.params.c_xyz.shape[0])
        views = [0] + list(range(1, 1 + min(bs, n_v - 1)))
        batch = assemble(views, list(range(min(bs, n_f))))
        lcfg = loss_config_from_opt(tr.opt, "s2")
        state = init_state(tr.state.params, tr.state.aux, step=0, seed=1)
        res_ms = {}
        for res in (128, 256, 512):
            step = make_train_step(tr.mcfg, lcfg, "s2", res, res, 1,
                                   len(views), min(bs, n_f),
                                   capacity=int(tr.opt.tile_capacity),
                                   lpips_fn=fit["lpips"],
                                   trainable_groups=test_modes.LATENT_GROUPS)
            state, m = step(state, batch)
            start = stamp()
            for _ in range(FT_RES_STEPS):
                state, m = step(state, batch)
            end = stamp()
            if not np.isfinite(float(m["loss"])) or int(m["nonfinite_grad"]):
                fail(f"phase 9 fine-tuning step at {res}^2: {float(m['loss'])}")
            res_ms[res] = ms_between(start, end) / FT_RES_STEPS
        del ft["run_test_motion"]["tr"], ft["run_test_unaligned_motion"]["tr"]
        del tr, state, assemble, batch, fit

        # the train CLI on synthetic videos, then its train_dynamic=False
        # route (the default test on that run's checkpoint)
        train = train_cli_runs(root, train_cfg, mode_now, want, dev)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    walls.update(train["walls"])
    launches.update(train["launches"])
    # every test mode uploads the CLI's zeros dataset, as the reference's
    # Trainer does (it is under DEVICE_DATA_MAX_BYTES)
    for name, _, _ in modes:
        if not (name in uploads and uploads[name]["on_card"]):
            fail(f"phase 9 {name}: the dataset was not uploaded: "
                 f"{uploads.get(name)}")

    by_mode = {}
    for m, w, n, ms in seq_ms:
        by_mode.setdefault(f"{m}@{w}", []).append(ms / n)
    by_mode = {k: sum(v) / len(v) for k, v in by_mode.items()}
    return {"walls": walls, "launches": launches, "small": small,
            "fps": results["fps"], "res_ms": res_ms, "uploads": uploads,
            "motion_s": motion_s, "frames": frame_stats["n"],
            "videos": len(videos), "seq_ms_by_mode": by_mode,
            "plots_3d": plots_3d,
            "seq_ms_per_frame": by_mode[f"default@{side}"],
            "ft": {k: {"moved": len(v["moved"]), "losses": v["losses"],
                       "step_ms": v["step_ms"]} for k, v in ft.items()},
            "train_gaussians": train["n_gaussians"],
            "train_renders_per_step": train["per_step"],
            "wall_s": time.time() - t_phase}


def train_cli_runs(root: str, train_cfg: str, mode_now: list, want,
                   device) -> dict:
    """The train CLI's body on `input_folder=synthetic` at a cut depth, then
    with train_dynamic=False on that run's checkpoint; launch counters
    asserted for each."""
    import torch
    from dimo_tpu_torch import cli
    from dimo_tpu_torch.io.config import load_config
    from dimo_tpu_torch.train import optim
    walls, launches = {}, {}
    free_cached()
    mode_now[0] = "train"
    train_dir = os.path.join(root, "train_run")
    targv = ["--config", train_cfg, "input_folder=synthetic",
             f"save_path={train_dir}",
             f"video_save_dir={os.path.join(root, 'train_videos')}",
             f"iters_s1={TRAIN_CLI_ITERS[0]}", f"iters_s2={TRAIN_CLI_ITERS[1]}"]
    topt = load_config(train_cfg, [])
    tb = int(topt.batch_size)
    n_sm = 2                                   # make_synthetic_videos' default
    per_step = (min(2 * tb, n_sm) * min(tb, int(topt.num_views))
                * min(tb, int(topt.num_frames)))
    zero_launch_counts()
    t0 = time.time()
    tr = cli.train_main(targv + ["train_dynamic=True"], device=device)
    torch.cuda.synchronize()
    walls["train"] = time.time() - t0
    launches["train"] = launch_counts()
    n1, n2 = TRAIN_CLI_ITERS
    expect = want(K1_ch7=per_step * (n1 + n2), K3=per_step * (n1 + n2),
                  K2=per_step * n2, K4=per_step * n2,
                  row_scatter=per_step * (n1 + n2))
    if launches["train"] != expect:
        fail(f"phase 9 train CLI: launches {launches['train']}, expected {expect}")
    bad = [k for k, v in optim.named_leaves(tr.state.params).items()
           if not bool(torch.isfinite(v).all())]
    if tr.stage != "s2" or bad or not os.path.exists(
            os.path.join(train_dir, "s2", "point_cloud.ply")):
        fail(f"phase 9 train CLI: stage {tr.stage}, non-finite {bad}")
    n_train = int(tr.state.aux.active.sum())
    del tr
    free_cached()
    train_data = motion_dirs(os.path.join(root, "train_data"), n_sm)
    mode_now[0] = "train_static"
    zero_launch_counts()
    t0 = time.time()
    cli.train_main(targv + ["train_dynamic=False", f"input_folder={train_data}"],
                   device=device)
    torch.cuda.synchronize()
    walls["train_static"] = time.time() - t0
    launches["train_static"] = launch_counts()
    tn_f = int(topt.num_frames)
    expect = want(K1_ch7=2 * tn_f * n_sm, K2=tn_f * n_sm)
    if launches["train_static"] != expect:
        fail(f"phase 9 train CLI (train_dynamic=False): launches "
             f"{launches['train_static']}, expected {expect}")
    for name in (f"{os.path.basename(train_dir)}_motion_00_s2_fixed.mp4",
                 "all_render_imgs.mp4"):
        if not os.path.exists(os.path.join(root, "train_videos", name)):
            fail(f"phase 9 train CLI (train_dynamic=False): no {name}")
    for name in ("train", "train_static"):
        print(f"phase 9 {name} CLI: {walls[name]:.2f} s, launches "
              + json.dumps({k: v for k, v in launches[name].items() if v}))
    return {"walls": walls, "launches": launches, "n_gaussians": n_train,
            "per_step": per_step}


def phase10(dev, card: str) -> dict:
    """Phase 10 (10a native I/O, 10b the parallel paths, 10c the quality
    run) under build/phase10/; prints each part's results and seconds and
    returns the launches per run and a summary."""
    import torch
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase10")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    a = native_phase(dev, root)
    h, n, d = a["packer"], a["numpy"], a["device"]
    print(f"phase 10a native library: {a['library']}; flagship PLY "
          f"({a['ply_gaussians']} Gaussians) native write / read "
          f"{a['ply_write_native_ms']:.1f} / {a['ply_read_native_ms']:.1f} ms, "
          f"numpy {a['ply_write_numpy_ms']:.1f} / {a['ply_read_numpy_ms']:.1f}"
          " ms, files and arrays equal")
    print(f"phase 10a dataset {HOST_DATA_SHAPE} ({a['dataset_bytes']} B, made "
          f"in {a['dataset_s']:.2f} s), s2 steps of 16 renders at "
          f"{WIDTH}^2, LPIPS off, a warm-up then twice {HOST_STEPS} timed, "
          f"the routes in turns: " + "; ".join(
              f"{name} {' / '.join(f'{x:.1f}' for x in r['step_ms'])} ms a "
              f"step, sample_batch "
              f"{', '.join(f'{x:.2f}' for x in r['batch_ms'])} ms"
              for name, r in (("on the host through the packer (page-locked "
                               f"{h['pinned']})", h),
                              ("on the host through numpy's gather", n),
                              ("on the device", d)))
          + f"; every host batch equal to the flat gather of its frames; "
          f"losses packer {h['losses']} numpy {n['losses']} device "
          f"{d['losses']}; launches {h['launches']}")
    print(f"phase 10a bench_train_torch.packer_probe (4 x 2 x 2 x 512^2, "
          f"batch 16, until the frames are on the card): host_batch_packer_ms "
          f"{a['host_batch_packer_ms']:.3f} host_batch_numpy_ms "
          f"{a['host_batch_numpy_ms']:.3f}; phase {a['wall_s']:.1f} s; {card}")
    torch.cuda.empty_cache()
    b = parallel_phase(dev, root)
    r0 = b["ranks"][0]
    print("phase 10b NCCL world 1 (Trainer, steps with make_mesh(1)) vs "
          "no mesh, 8 renders a step: " + "; ".join(
              f"step {s['step']} loss {s['dp_loss']:.6f} vs {s['ref_loss']:.6f}"
              for s in b["nccl_world1"]) + f"; launches {b['nccl_launches']}")
    for r, res in enumerate(b["ranks"]):
        print(f"phase 10b rank {r} of {PARALLEL_WORLD} (gloo, one card): "
              f"loss {res['loss']:.6f} vs data_parallel=1 {res['ref_loss']:.6f}"
              f"; worst gradient relative L2 "
              f"{max(res['grad_rel_l2'].values()):.3e}; parameters equal to "
              f"rank 0's; launches {res['launches']}; step "
              f"{res['dp_step_s'] * 1e3:.1f} ms at data_parallel=2 (both "
              f"ranks on the card at once) vs {res['ref_step_s'] * 1e3:.1f} "
              f"ms for the whole batch on one rank, the other waiting; fps "
              f"render sharded: ch3 and ch7 images "
              f"bit-equal, {res['fps_sp']:.2f} frames/s sharded vs "
              f"{res['fps_full']:.2f} unsharded ({SP_FPS_ROUNDS} rounds)")
    print(f"phase 10b: ranks {b['ranks_s']:.1f} s (spawn to join), phase "
          f"{b['wall_s']:.1f} s; no multi-card speed is measured (one card)")
    torch.cuda.empty_cache()
    c = quality_phase(dev, root)
    print(f"phase 10c eval_quality_torch.py --fast --iters {QUALITY_ITERS}: "
          f"PSNR {c['psnr']} dB (gate {c['gate']}), {c['n_gaussians']} "
          f"Gaussians, eval_capacity {c['eval_capacity']} (the trainer's live "
          f"capacity), {c['sec_per_step']} s a step, videos_ok "
          f"{c['videos_ok']} videos_error {c['videos_error']}; phase "
          f"{c['wall_s']:.1f} s")
    return {"launches": {"packer_route": h["launches"],
                         "numpy_route": n["launches"],
                         "device_route": d["launches"],
                         "nccl_world1": b["nccl_launches"],
                         "two_ranks_each": {
                             **r0["launches"],
                             "K1 ch3": r0["fps_sp_k1_ch3"]}},
            "summary": {
                "native_library": a["library"],
                "packer_step_ms": h["step_ms"], "numpy_step_ms": n["step_ms"],
                "device_step_ms": d["step_ms"],
                "packer_batch_ms": h["batch_ms"],
                "numpy_batch_ms": n["batch_ms"],
                "device_batch_ms": d["batch_ms"],
                "host_batch_packer_ms": a["host_batch_packer_ms"],
                "host_batch_numpy_ms": a["host_batch_numpy_ms"],
                "dp2_step_ms": [r["dp_step_s"] * 1e3 for r in b["ranks"]],
                "dp1_step_ms": [r["ref_step_s"] * 1e3 for r in b["ranks"]],
                "dp2_grad_rel_l2": [max(r["grad_rel_l2"].values())
                                    for r in b["ranks"]],
                "sp_fps": [r["fps_sp"] for r in b["ranks"]],
                "fps_unsharded": [r["fps_full"] for r in b["ranks"]],
                "quality_fast": c,
                "wall_s": {"10a": a["wall_s"], "10b": b["wall_s"],
                           "10c": c["wall_s"]}}}


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
        from dimo_tpu_torch.ops.rasterizer import gather as rg
        from dimo_tpu_torch.ops.rasterizer import projection, strips, tiles
        from dimo_tpu_torch.ops.rasterizer import windowdma as wd
        from dimo_tpu_torch.ops.rasterizer.api import camera_tensors
        from dimo_tpu_torch.scenes import flagship_scene
        from dimo_tpu_torch.train import optim
        from dimo_tpu_torch.train.step import (LossConfig, group_lrs,
                                               init_state, make_train_step)
        from dimo_tpu_torch.models.lpips import get_lpips, random_init_lpips
        import bench_torch
    except ImportError as e:
        fail(f"the port is not importable here ({e}): run from a checkout")

    dev = torch.device("cuda")
    t_start = time.time()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"tf32_matmul={torch.backends.cuda.matmul.allow_tf32}")
    card = bench_torch.card_line()
    print("card:", card)

    # --- 1. build -------------------------------------------------------
    t0 = time.time()
    logs = build.build()
    print(f"build: {time.time() - t0:.1f} s")
    for name, log in logs.items():
        for ln in ptxas_summary(log):
            print(f"  ptxas[{name}]: {ln}")
    if sys.argv[1:] == ["--phase", "timing"]:
        print("timing " + json.dumps(scatter_timing(dev)))
        sys.exit(0)
    if sys.argv[1:] == ["--phase", "determinism"]:
        determinism_probe(dev)
        print(f"chip_smoke --phase determinism: done in "
              f"{time.time() - t_start:.1f} s")
        sys.exit(0)
    if sys.argv[1:] == ["--phase", "10"]:
        # a development run of phase 10 alone: no result line
        phase10(dev, card)
        print(f"chip_smoke --phase 10: passed in {time.time() - t_start:.1f} s")
        sys.exit(0)

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
    before = sg.launches
    k2_graph = graph_ms(lambda: sg.gather_small_cols(table_t, nn_idx), 200)
    if sg.launches - before != 203:
        fail(f"K2's counter moved {sg.launches - before} times over 3 "
             f"warm-up calls and 200 captured ones")
    k2_lib_graph = graph_ms(lambda: torch.index_select(table_t, 1, flat), 200)
    s_sites = nn_idx.numel()
    k2_bytes = s_sites * 4 + table_t.numel() * 4 + 11 * s_sites * 4
    k2_cases = k2_edge_cases(dev, table_t, nn_idx)
    print("K2 bit-exact vs plain also for: " + "; ".join(k2_cases))
    fill = torch.empty((11, s_sites), device=dev)
    k2_fill = graph_ms(lambda: fill.fill_(0.5), 200)
    del fill
    print(f"K2 yardstick: fill_ of its (11, {s_sites}) float32 output in a "
          f"CUDA graph {k2_fill:.5f} ms")
    print(f"K2 gather_small_cols (11, {table_t.shape[1]}) x {tuple(nn_idx.shape)}:"
          f" bit-exact vs plain; {k2_ms:.4f} ms (plain {k2_plain:.4f}, "
          f"index_select {k2_lib:.4f}); in a CUDA graph {k2_graph:.5f} ms "
          f"(index_select {k2_lib_graph:.5f})")
    torch.cuda.synchronize()

    # --- 2b. K1 against its plain version at the flagship lists ---------
    with torch.no_grad():
        means3d, rots = deform.lbs_blend(
            params.xyz, params.rotation, params.c_xyz, d_xyz, d_rot,
            G.get_c_radius(params), knn[1], knn[0])
        wv, fp, cp = camera_tensors(cam, dev)

    def lists_at(h: int, w: int, capacity: int):
        """The flagship frame's coefficient table, strip lists and
        projection at h x w, `capacity`."""
        with torch.no_grad():
            pr = projection.project(
                means3d, G.get_scaling(params, "s2"), rots,
                G.get_opacity(params), G.get_features(params), wv, fp, cp,
                float(cam.tan_fovx), float(cam.tan_fovy), w, h,
                valid=aux.active)
            ls = strips.build_strip_lists(pr.mean2d, pr.cull_radius,
                                          pr.depth, pr.in_frustum, h, w,
                                          capacity)
            tb = strips.coef_table(pr.mean2d, pr.conic,
                                   G.get_opacity(params), pr.color, pr.depth,
                                   pr.normal, h, w)
        return tb, ls, pr

    table, lists, p = lists_at(HEIGHT, WIDTH, CAPACITY)
    ns = lists.count.shape[0]
    print("strip lists " + strip_histogram(lists.count, CAPACITY)
          + f"; overflow {int(lists.overflow)}")
    occ = strip_occupancy()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    nblocks = ns * cs.GROUPS
    print(f"K1/K3 layout: {nblocks} blocks of {cs.CHUNK} threads at "
          f"{WIDTH}^2 ({cs.GROUPS} row groups a strip, "
          f"{cs.ROWS_PER_THREAD} rows a thread); resident blocks per SM: K1 "
          f"ch7 {occ['ch7']}, ch3 {occ['ch3']}, K3 {occ['bwd']}, K3's group "
          f"pass {occ['combine']}; {sms} SMs, so K1 ch7 runs in "
          f"{nblocks / (sms * occ['ch7']):.2f} waves and K3 in "
          f"{nblocks / (sms * occ['bwd']):.2f}")
    res = check_strip_kernels(table, lists.idx, lists.count, HEIGHT, WIDTH,
                              "the flagship lists")
    tfin = res["tfin"]
    walk7 = torch.clamp(lists.count.long(), 0, CAPACITY)[:, None].expand(
        ns, res["walk"].shape[1])
    pairs7, live7 = pair_counts(table, lists.idx, walk7, HEIGHT, WIDTH)
    pairs3, live3 = pair_counts(table, lists.idx, res["walk"], HEIGHT, WIDTH)
    print(f"pixel-entry pairs: ch7 {pairs7}, of which alpha > 0 {live7} "
          f"({live7 / pairs7:.4f}); ch3 {pairs3} ({pairs3 / pairs7:.4f} of "
          f"ch7's; {int((res['walk'] < walk7).sum())} of {walk7.numel()} row "
          f"groups stop early), alpha > 0 {live3}")
    k1 = {}
    for ch in (7, 3):
        fn = (lambda ch=ch: cs.composite_strips(table, lists.idx, lists.count,
                                                HEIGHT, WIDTH, ch))
        ms = cuda_ms(fn, 50)
        gms = graph_ms(fn, 50)
        plain_ms = cuda_ms(lambda: cs.composite_strips_plain(
            table, lists.idx, lists.count, HEIGHT, WIDTH, ch), 2, warmup=1)
        pairs, live = (pairs7, live7) if ch == 7 else (pairs3, live3)
        n_entries = res["entries"] if ch == 7 else res["entries3"]
        nbytes = (table.numel() * 4 + n_entries * 4 + ns * 4
                  + (ch + 1) * HEIGHT * WIDTH * 4)
        k1[ch] = dict(
            err=0.0 if ch == 7 else res["err3"], ms=ms, graph_ms=gms,
            plain_ms=plain_ms, entries=n_entries, pairs=pairs, live=live,
            ops=pairs * K1_OPS_POWER + live * (K1_OPS_BASE - K1_OPS_POWER
                                               + 2 * ch),
            dense_ops=n_entries * 32 * 32 * (K1_OPS_BASE + 2 * ch),
            bytes=nbytes, blocks_per_sm=occ[f"ch{ch}"])
        print(f"K1 composite ch{ch}{' early-exit' if ch != 7 else ''}: "
              + ("bit-exact vs plain" if ch == 7 else
                 f"max |err| {res['err3']:.3g} (tol 5e-4)")
              + f"; {ms:.4f} ms, in a CUDA graph {gms:.4f} ms (plain "
              f"{plain_ms:.2f}); {n_entries} entries composited of "
              f"{int(lists.count.sum())} listed (the most of a strip's row "
              f"groups), {pairs} pixel-entry pairs")
    torch.cuda.synchronize()

    # --- 2c. K3 against its plain version at the flagship lists --------
    gout = res["gout"]
    k3_err, k3_rel = res["k3_err"], res["k3_rel"]
    k3_fn = (lambda: cs.composite_strips_bwd(table, lists.idx, lists.count,
                                             tfin, gout))
    k3_ms = cuda_ms(k3_fn, 20)
    k3_graph = graph_ms(k3_fn, 20)
    k3_plain = cuda_ms(lambda: cs.composite_strips_bwd_plain(
        table, lists.idx, lists.count, tfin, gout), 1, warmup=1)
    k3_entries = k1[7]["entries"]
    k3_ops = pairs7 * K1_OPS_POWER + live7 * (K3_OPS - K1_OPS_POWER)
    k3_bytes = (k3_entries * (64 + 4) + ns * 4 + 9 * HEIGHT * WIDTH * 4
                + lists.idx.numel() * 16 * 4)
    print(f"K3 composite bwd: 0 slots over tol; max |err| {k3_err:.3g} "
          f"({k3_rel:.3g} of the lane max); bit-identical on a second run; "
          f"{k3_ms:.4f} ms, in a CUDA graph {k3_graph:.4f} ms (plain "
          f"{k3_plain:.2f}); {k3_entries} entries")
    edge = strip_edge_cases(dev, lists_at)
    print("K1 (ch7 bit-exact, ch3 within 5e-4 and stopping where the replay "
          "stops) and K3 (1e-4 of each lane's max, zeros past the count, "
          "bit-identical twice) also on: " + "; ".join(edge))

    # --- 2d. K4 against its plain version at the flagship shapes --------
    m = table_t.shape[1]
    smem4 = sg.rows_bwd_smem(m, 11)
    occ4 = dict(zip(("K4 block", "K4 combine"), sg.cols_occupancy(dev, smem4)))
    route4, grid4, per4 = sg.cols_bwd_plan(
        11, m, s_sites, lambda b: sg.cols_occupancy(dev, b)[0], sms)
    if route4 != "tables":
        fail(f"K4 takes the {route4} route at the LBS shape (11, {m})")
    ptx4 = {k: ptxas_kernel(logs["smallgather"], n) for k, n in (
        ("K4 block", "scatter_block_kernelILb1"),
        ("K4 combine", "combine_tables"),
        ("K4 sorted tiles", "segment_tiles_kernelILb1"),
        ("K4 sorted runs", "segment_runs_kernelILb1"))}
    for k, v in ptx4.items():
        print(f"  {k}: ptxas {v}" + (f"; {occ4[k]} resident blocks per SM"
                                     if k in occ4 else ""))
    print(f"K4 {route4} route at (11, {m}): {smem4} bytes of shared memory a "
          f"block, {grid4} blocks of {per4} sites, scratch {grid4 * smem4} "
          f"bytes")
    g4 = torch.randn((11,) + tuple(nn_idx.shape),
                     generator=torch.Generator().manual_seed(12)).to(dev)
    got = sg.gather_small_cols_bwd(g4, nn_idx, m)
    again = sg.gather_small_cols_bwd(g4, nn_idx, m)
    # the plain version sums in the kernel's order, given the card's plan
    ref = sg.gather_small_cols_bwd_plain(g4, nn_idx, m, (grid4, per4))
    torch.cuda.synchronize()
    k4_err = float((got - ref).abs().max())
    k4_identical = torch.equal(got, again)
    if not (torch.equal(got, ref) and k4_identical):
        fail(f"K4 at the LBS shape: equal to its plain version "
             f"{torch.equal(got, ref)} (max |err| {k4_err}), the same bits "
             f"on a second run {k4_identical}")
    print("K4 at the LBS shape: bit-equal to its plain version (the same "
          "order) and bit-identical on a second run")
    k4_cases = k4_edge_cases(dev, table_t, nn_idx)
    print("K4 (bit-equal to its plain version, and on a second run) also "
          "on: " + "; ".join(k4_cases))
    g4_flat = g4.reshape(11, -1)
    k4_ms = cuda_ms(lambda: sg.gather_small_cols_bwd(g4, nn_idx, m), 200)
    k4_plain = cuda_ms(lambda: sg.gather_small_cols_bwd_plain(g4, nn_idx, m),
                       5)
    k4_lib = cuda_ms(lambda: torch.zeros((11, m), device=dev).index_add_(
        1, flat, g4_flat), 200)
    before = sg.bwd_launches
    k4_graph = graph_ms(lambda: sg.gather_small_cols_bwd(g4, nn_idx, m), 200)
    if sg.bwd_launches - before != 203:
        fail(f"K4's counter moved {sg.bwd_launches - before} times over 3 "
             f"warm-up calls and 200 captured ones")
    k4_lib_graph = graph_ms(lambda: torch.zeros((11, m), device=dev).index_add_(
        1, flat, g4_flat), 200)
    k4_bytes = s_sites * 4 + 11 * s_sites * 4 + 11 * m * 4
    print(f"K4 gather_small_cols bwd (11, {s_sites}) -> (11, {m}): max |err| "
          f"{k4_err:.3g}; {k4_ms:.4f} ms (plain {k4_plain:.4f}, index_add_ "
          f"{k4_lib:.4f}); in a CUDA graph {k4_graph:.5f} ms (index_add_ "
          f"{k4_lib_graph:.5f})")
    torch.cuda.synchronize()

    # --- 2e. K7 against its plain version; the lists by both routes -----
    t_phase = time.time()
    seen = {}
    real_gather = wd.gather_windows

    def spy(pairs_, starts_, capacity_):
        seen.update(pairs=pairs_, starts=starts_)
        return real_gather(pairs_, starts_, capacity_)

    def strip_lists():
        return strips.build_strip_lists(p.mean2d, p.cull_radius, p.depth,
                                        p.in_frustum, HEIGHT, WIDTH, CAPACITY)

    tiles.WINDMA, wd.gather_windows = 1, spy
    try:
        lists_w = strip_lists()
    finally:
        tiles.WINDMA, wd.gather_windows = 0, real_gather
    torch.cuda.synchronize()
    for f in ("idx", "count", "overflow", "overflow_max"):
        if not torch.equal(getattr(lists_w, f), getattr(lists, f)):
            fail(f"strip lists by the two readout routes differ in {f}")
    pairs, starts = seen["pairs"], seen["starts"]
    nd, nt = pairs.shape[0], starts.shape[0]
    got = wd.gather_windows(pairs, starts, CAPACITY)
    ref = wd.gather_windows_plain(pairs, starts, CAPACITY)
    torch.cuda.synchronize()
    k7_err = float((got.long() - ref.long()).abs().max())
    if got.shape != (nt, CAPACITY, 2) or not torch.equal(got, ref):
        fail(f"K7 disagrees with its plain version: max |err| {k7_err}")
    k7_cases = k7_edge_cases(dev, pairs, starts, CAPACITY)
    print("K7 bit-exact vs plain also for: " + "; ".join(k7_cases))
    tiny = torch.zeros(1, device=dev)
    launch_floor = graph_ms(lambda: tiny.add_(1), 200)
    print(f"K7 yardstick: a one-element add_ in a CUDA graph "
          f"{launch_floor:.5f} ms")
    starts_even, starts_odd = starts & ~1, torch.clamp_max(starts | 1, nd)
    k7_even = graph_ms(lambda: wd.gather_windows(pairs, starts_even, CAPACITY),
                       200)
    k7_odd = graph_ms(lambda: wd.gather_windows(pairs, starts_odd, CAPACITY),
                      200)
    print(f"K7 in a CUDA graph with every start even (16-byte loads): "
          f"{k7_even:.5f} ms, every start odd (8-byte loads): {k7_odd:.5f} ms")
    rows_lib = (starts[:, None] + torch.arange(CAPACITY, device=dev)[None]
                ).clamp_max(nd - 1).long()
    k7_ms = cuda_ms(lambda: wd.gather_windows(pairs, starts, CAPACITY), 200)
    k7_plain = cuda_ms(lambda: wd.gather_windows_plain(pairs, starts,
                                                       CAPACITY), 50)
    k7_lib = cuda_ms(lambda: pairs[rows_lib], 200)
    before = wd.launches
    k7_graph = graph_ms(lambda: wd.gather_windows(pairs, starts, CAPACITY), 200)
    if wd.launches - before != 203:
        fail(f"K7's counter moved {wd.launches - before} times over 3 "
             f"warm-up calls and 200 captured ones")
    k7_lib_graph = graph_ms(lambda: pairs[rows_lib], 200)
    k7_bytes = 2 * nt * CAPACITY * 8 + nt * 4
    route_ms = {0: [], 1: []}
    for route in (0, 1, 1, 0) * 3:
        tiles.WINDMA = route
        route_ms[route].append(cuda_ms(strip_lists, 5, warmup=1))
    tiles.WINDMA = 0
    route_ms = {r: sum(v) / len(v) for r, v in route_ms.items()}
    print(f"K7 gather_windows ({nd}, 2) x ({nt},) capacity {CAPACITY}: "
          f"bit-exact vs plain; "
          f"{k7_ms:.4f} ms (plain {k7_plain:.4f}, advanced index "
          f"{k7_lib:.4f}); in a CUDA graph {k7_graph:.5f} ms (advanced index "
          f"{k7_lib_graph:.5f}); strip lists equal by both routes; binning stage "
          f"{route_ms[0]:.3f} ms by gather, {route_ms[1]:.3f} ms by K7 "
          f"(mean of 6 x 5, alternating); phase {time.time() - t_phase:.1f} s")

    # --- 2f. K5/K6 against their plain versions at the LBS shape --------
    rows_res = rows_gather_phase(dev, table_t, nn_idx, logs["smallgather"])

    # --- 2h. the row scatter at the flagship frame's strip lists --------
    scat = row_scatter_phase(dev, table, lists, tfin, res["gout"],
                             logs["smallgather"])

    # --- 2g. K8/K9 against their plain versions at the flagship tiles ---
    tile_res = tile_kernels_phase(dev, p, G.get_opacity(params).detach(),
                                  lists_at, logs["composite_tiles"])

    # --- 3. small render on the card vs the same render on the CPU ------
    small = []
    for where in (dev, torch.device("cpu")):
        c2, p2, a2, cam2 = flagship_scene(2048, 32, 8, seed=3, device=where)
        with torch.no_grad():
            small.append([render(c2, p2, a2, cam2, 0.35, "s2", 1, 256, 256,
                                 torch.ones(3, device=where), capacity=1024,
                                 channels=ch) for ch in (7, 3)])
    for i, ch in enumerate((7, 3)):
        on_card = {k: small[0][i][k].cpu()
                   for k in ("image", "alpha", "depth", "normal")}
        compare_planes(on_card, small[1][i], 1e-4 if ch == 7 else 5e-4,
                       f"small render ch{ch} card vs CPU")
        print(f"small render ch{ch} 256^2: card vs CPU max |err| "
              f"{float((on_card['image'] - small[1][i]['image']).abs().max()):.3g}")
    torch.cuda.synchronize()

    # --- 3b. small train step on the card vs the CPU ---------------------
    t0 = time.time()
    loss_gpu, g_gpu = small_train_grads(dev)
    loss_cpu, g_cpu = small_train_grads(torch.device("cpu"))
    if not abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu):
        fail(f"small train step: loss card {loss_gpu} vs CPU {loss_cpu}")
    worst = compare_grads(g_gpu, g_cpu, 1e-3, "small train step card vs CPU")
    print(f"small train step 2x1x2 at 256^2: loss card {loss_gpu:.6f} CPU "
          f"{loss_cpu:.6f}; worst gradient {worst[0]} relative L2 "
          f"{worst[1]:.3g} ({len(g_cpu)} leaves; {time.time() - t0:.1f} s)")

    # --- 3c. small stage-1 step on the card vs the CPU -------------------
    t0 = time.time()
    s1_gpu, s1_cpu = small_s1_step(dev), small_s1_step(torch.device("cpu"))
    if s1_gpu["skipped"] or s1_cpu["skipped"]:
        fail("small s1 step: the step was skipped as non-finite")
    if not abs(s1_gpu["loss"] - s1_cpu["loss"]) <= 1e-4 * abs(s1_cpu["loss"]):
        fail(f"small s1 step: loss card {s1_gpu['loss']} vs CPU "
             f"{s1_cpu['loss']}")
    # with one shared radius the covariance does not depend on the
    # rotations: their gradient is rounding noise on both devices
    worst = compare_grads(s1_gpu["grads"], s1_cpu["grads"], 1e-3,
                          "small s1 step card vs CPU", noise_floor=1e-6)
    if float(s1_cpu["grads"]["mean2d_tap"].abs().sum()) == 0:
        fail("small s1 step: the tap carries no gradient")
    for f in ("denom", "max_radii2d"):
        if not torch.equal(s1_gpu["aux"][f], s1_cpu["aux"][f]) \
                or float(s1_cpu["aux"][f].sum()) <= 0:
            fail(f"small s1 step: {f} differs between card and CPU")
    acc = rel_l2(s1_gpu["aux"]["xyz_grad_accum"], s1_cpu["aux"]["xyz_grad_accum"])
    if not acc <= 1e-3:
        fail(f"small s1 step: xyz_grad_accum card vs CPU relative L2 {acc}")
    print(f"small s1 step 2x1x2 at 256^2 (GT 512^2 resized): loss card "
          f"{s1_gpu['loss']:.6f} CPU {s1_cpu['loss']:.6f}; worst gradient "
          f"{worst[0]} relative L2 {worst[1]:.3g}; denom and max_radii2d "
          f"equal, xyz_grad_accum {acc:.3g} ({time.time() - t0:.1f} s)")

    # --- 3d. small tile-path render and gradient, card vs CPU ------------
    t0 = time.time()
    (t_gpu, tg_gpu), (t_cpu, tg_cpu) = (small_tile_render(dev),
                                        small_tile_render(torch.device("cpu")))
    if int(t_gpu["overflow"]) != int(t_cpu["overflow"]):
        fail("small tile render: overflow differs between card and CPU")
    t_err = compare_planes(t_gpu, t_cpu, 1e-4, "small tile render card vs CPU")
    t_worst = compare_grads(tg_gpu, tg_cpu, 1e-3,
                            "small tile render card vs CPU", noise_floor=1e-6)
    print(f"small tile-path render 256^2 (K8, K9, K2, K4): card vs CPU max "
          f"|err| {t_err:.3g}; worst gradient {t_worst[0]} relative L2 "
          f"{t_worst[1]:.3g} ({len(tg_cpu)} leaves; {time.time() - t0:.1f} s)")

    # --- 4. the serving path (no graph recorded) --------------------------
    with torch.no_grad():
        cs.launches = dict.fromkeys(cs.launches, 0)
        sg.launches = 0
        sg.bwd_launches = 0
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
    if cs.launches["bwd"] or sg.bwd_launches:
        fail("the serving path launched a backward kernel")
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

    # --- 6. the training path at full width (bench_train.py's shape) ---
    n_m, n_v, n_f = TRAIN_SHAPE
    b = n_m * n_v * n_f
    lcfg = LossConfig()
    state = init_state(params, aux, step=TRAIN_START - 1)
    batch = train_batch(params, TRAIN_SHAPE, WIDTH, dev, seed=0)
    step_fn = make_train_step(cfg, lcfg, "s2", WIDTH, HEIGHT, n_m, n_v, n_f,
                              capacity=CAPACITY, use_guidance=True)
    before = {k: v.detach().clone()
              for k, v in optim.named_leaves(params).items()}
    marks = []

    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append((name, ev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    metrics = []
    t_first = time.time()
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            first_s = time.time() - t_first
            t0 = time.time()
        marks.append([])
        mark("start")
        state, m = step_fn(state, batch, mark=mark)
        metrics.append(m)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / TRAIN_STEPS * 1e3
    peak_no_lp = torch.cuda.max_memory_allocated() / 2**30
    train_launch = {"K1 ch7": cs.launches["ch7"], "K2": sg.launches,
                    "K3": cs.launches["bwd"], "K4": sg.bwd_launches,
                    "row scatter": rg.launches}
    for i, m in enumerate(metrics):
        if not bool(torch.isfinite(m["loss"])) or int(m["nonfinite_grad"]):
            fail(f"train step {i}: loss {float(m['loss'])}, nonfinite_grad "
                 f"{int(m['nonfinite_grad'])}")
    want = b * (1 + TRAIN_STEPS)
    if any(v != want for v in train_launch.values()) or cs.launches["ch3"]:
        fail(f"train launches {train_launch} (ch3 {cs.launches['ch3']}), "
             f"expected {want} each")
    lrs = group_lrs(lcfg, state.step, "s2")
    after = optim.named_leaves(params)
    stuck = sorted({optim.leaf_group(k) for k, v in before.items()
                    if v.numel() and lrs[optim.leaf_group(k)] > 0
                    and torch.equal(v, after[k].detach())})
    if stuck:
        fail(f"train: groups with a learning rate did not move: {stuck}")
    split = {}
    for step_marks in marks[1:]:
        for (_, a), (name, e) in zip(step_marks, step_marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(e) / TRAIN_STEPS
    last = metrics[-1]
    print(f"train path: {b} renders/step at {WIDTH}^2, {params.xyz.shape[0]} "
          f"Gaussians, capacity {CAPACITY}, steps {TRAIN_START}.."
          f"{state.step}: first step {first_s:.2f} s, steady {step_ms:.1f} "
          f"ms/step (host clock, mean of {TRAIN_STEPS}); launches "
          f"{train_launch}; peak memory {peak_no_lp:.2f} GiB")
    print("train split (CUDA events, ms/step): "
          + " ".join(f"{k}={v:.1f}" for k, v in split.items())
          + f" total={sum(split.values()):.1f}")
    print("train metrics (last step): " + " ".join(
        f"{k}={float(last[k]):.5g}" for k in
        ("loss", "mse", "psnr", "ssim_loss", "mask_loss", "smooth",
         "bilateral", "arap", "ga", "grad_norm", "overflow")))
    spread = {"6": step_spread(step_fn, state, batch, lcfg)}
    print_spread("6", spread["6"])

    # --- 6b. the same training path with LPIPS on (the seeded fallback) --
    lpips_fn = random_init_lpips(0, dev)
    step_lp = make_train_step(cfg, lcfg, "s2", WIDTH, HEIGHT, n_m, n_v, n_f,
                              capacity=CAPACITY, lpips_fn=lpips_fn,
                              use_guidance=True)
    before = {k: v.detach().clone()
              for k, v in optim.named_leaves(params).items()}
    marks.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    metrics_lp = []
    for i in range(1 + TRAIN_STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.time()
        marks.append([])
        mark("start")
        state, m = step_lp(state, batch, mark=mark)
        metrics_lp.append(m)
    torch.cuda.synchronize()
    step_lp_ms = (time.time() - t0) / TRAIN_STEPS * 1e3
    peak_lp = torch.cuda.max_memory_allocated() / 2**30
    lp_launch = {"K1 ch7": cs.launches["ch7"], "K2": sg.launches,
                 "K3": cs.launches["bwd"], "K4": sg.bwd_launches,
                 "row scatter": rg.launches}
    for i, m in enumerate(metrics_lp):
        if (not bool(torch.isfinite(m["loss"])) or int(m["nonfinite_grad"])
                or not float(m["lpips"]) > 0):
            fail(f"LPIPS train step {i}: loss {float(m['loss'])}, lpips "
                 f"{float(m['lpips'])}, nonfinite_grad "
                 f"{int(m['nonfinite_grad'])}")
    if any(v != want for v in lp_launch.values()) or cs.launches["ch3"]:
        fail(f"LPIPS train launches {lp_launch} (ch3 {cs.launches['ch3']}), "
             f"expected {want} each")
    lrs = group_lrs(lcfg, state.step, "s2")
    after = optim.named_leaves(params)
    stuck = sorted({optim.leaf_group(k) for k, v in before.items()
                    if v.numel() and lrs[optim.leaf_group(k)] > 0
                    and torch.equal(v, after[k].detach())})
    if stuck:
        fail(f"LPIPS train: groups with a learning rate did not move: {stuck}")
    split_lp = {}
    for step_marks in marks[1:]:
        for (_, a), (name, e) in zip(step_marks, step_marks[1:]):
            split_lp[name] = (split_lp.get(name, 0.0)
                              + a.elapsed_time(e) / TRAIN_STEPS)
    last = metrics_lp[-1]
    print(f"LPIPS train path (seeded random-VGG LPIPS, lambda "
          f"{lcfg.lambda_lpips:g}, float32 convolutions): steady "
          f"{step_lp_ms:.1f} ms/step against {step_ms:.1f} without LPIPS "
          f"(host clock, mean of {TRAIN_STEPS} each, steps {state.step - 2}"
          f"..{state.step}); launches {lp_launch}; peak memory "
          f"{peak_lp:.2f} GiB (without LPIPS {peak_no_lp:.2f})")
    print("LPIPS train split (CUDA events, ms/step; lpips = both towers' "
          "forward and the GT's conversion): "
          + " ".join(f"{k}={v:.1f}" for k, v in split_lp.items())
          + f" total={sum(split_lp.values()):.1f}")
    print("LPIPS train metrics (last step): " + " ".join(
        f"{k}={float(last[k]):.5g}" for k in
        ("loss", "lpips", "mse", "ssim_loss", "arap", "grad_norm")))
    spread["6b"] = step_spread(step_lp, state, batch, lcfg)
    print_spread("6b", spread["6b"])
    # TF32 against float32 on one motion's renders and their GT
    with torch.no_grad():
        knn_b = find_knn(params, aux)
        per = n_v * n_f
        imgs = torch.stack([render(
            cfg, params, aux, batch["camera"][j], float(batch["times"][j]),
            "s2", int(batch["latent_idx"][j]), WIDTH, HEIGHT, bg,
            knn_cache=knn_b, capacity=CAPACITY)["image"] for j in range(per)])
        gts = (batch["gt_image"][:per].float() / 255.0).permute(0, 3, 1, 2)
    gts = gts.contiguous()
    prec = lpips_precision(imgs, gts)
    print(f"LPIPS precision ({per} renders at {WIDTH}^2 vs their GT): TF32 "
          f"vs float32 distances {prec['dist_rel']:.3g} relative (float32 "
          f"{prec['dist_f32']}), input gradient {prec['grad_rel_l2']:.3g} "
          f"relative L2 ({prec['grad_max']:.3g} max); forward ms TF32 "
          f"{prec['tf32_fwd_ms']:.2f} float32 {prec['float32_fwd_ms']:.2f}, "
          f"forward + backward TF32 {prec['tf32_fwd_bwd_ms']:.2f} float32 "
          f"{prec['float32_fwd_bwd_ms']:.2f}; global flag swapped: TF32 "
          f"{prec['tf32_flags_swapped_dist']:.3g} / "
          f"{prec['tf32_flags_swapped_grad']:.3g}, float32 "
          f"{prec['float32_flags_swapped_dist']:.3g} / "
          f"{prec['float32_flags_swapped_grad']:.3g} (distance / gradient "
          "max |diff|)")
    tf32_ok = (prec["dist_rel"] <= LPIPS_TF32_DIST_REL
               and prec["grad_rel_l2"] <= LPIPS_TF32_GRAD_REL_L2)
    print(f"LPIPS precision: TF32 {'within' if tf32_ok else 'outside'} "
          f"{LPIPS_TF32_DIST_REL:g} (distances) / {LPIPS_TF32_GRAD_REL_L2:g} "
          "(gradient); the step's LPIPS runs in float32")
    with torch.no_grad():
        shipped = lpips_fn(imgs, gts)
    if not torch.equal(shipped, torch.tensor(prec["dist_f32"], device=dev)):
        fail("the train step's LPIPS does not give the float32 distances")
    for k in ("tf32", "float32"):
        if (prec[f"{k}_flags_swapped_dist"] > 0.1 * prec["dist_max"]
                or prec[f"{k}_flags_swapped_grad"] > 0.1 * prec["grad_max"]):
            fail(f"LPIPS {k}: cuDNN's global TF32 flag changed the result "
                 "(each pass should set its own precision)")

    # --- 6c. one test-time fine-tuning step: only the latent codes train -
    step_ft = make_train_step(cfg, lcfg, "s2", WIDTH, HEIGHT, n_m, n_v, n_f,
                              capacity=CAPACITY, lpips_fn=lpips_fn,
                              use_guidance=True,
                              trainable_groups=frozenset({"latent_code"}))
    before = {k: v.detach().clone()
              for k, v in optim.named_leaves(params).items()}
    state, m_ft = step_ft(state, batch)
    after = optim.named_leaves(params)
    moved = sorted(k for k, v in before.items()
                   if not torch.equal(v, after[k].detach()))
    if (moved != ["latent.codes"] or float(m_ft["arap"]) != 0.0
            or int(m_ft["nonfinite_grad"]) or not float(m_ft["lpips"]) > 0):
        fail(f"fine-tuning step: leaves that moved {moved} (want only "
             f"latent.codes), arap {float(m_ft['arap'])}, lpips "
             f"{float(m_ft['lpips'])}")
    print(f"fine-tuning step (trainable_groups={{'latent_code'}}, LPIPS on): "
          f"only latent.codes moved (max |step| "
          f"{float((after['latent.codes'] - before['latent.codes']).abs().max()):.3g}), "
          f"every other leaf bit-equal, arap {float(m_ft['arap'])}, loss "
          f"{float(m_ft['loss']):.5g}")

    # --- profile: one LPIPS-on step under torch.profiler ----------------
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "profile_lpips_step")
    busy = profiled_step(step_lp, state, batch, trace_dir)
    if busy["kernels"]:
        print(f"profiled LPIPS step: the card was busy "
              f"{busy['busy_share']:.4f} of the step's window "
              f"({busy['busy_us'] / 1e3:.1f} of {busy['window_us'] / 1e3:.1f}"
              f" ms, {busy['kernels']} kernels; trace "
              f"{os.path.relpath(trace_dir)}); most device time: "
              + "; ".join(f"{n[:60]} {us / 1e3:.2f} ms" for n, us in
                          busy["by_name"][:12]))
    else:
        print("profiled LPIPS step: the trace holds no kernel events; the "
              "busy share is not measured")

    # --- 7. the two-stage trainer, window readout route on ---------------
    del state, batch, step_fn, step_lp, step_ft, before, after, metrics
    del metrics_lp, imgs, gts
    torch.cuda.empty_cache()
    tiles.WINDMA = 1
    print(f"trainer path: tiles.WINDMA = {tiles.WINDMA} (every render reads "
          "its bin windows through K7); LPIPS as `main_train_dimo.py` sets "
          "it by default: trained weights if present, else the seeded "
          "fallback")
    trainer_lpips = get_lpips("weights/lpips_vgg.npz", fallback="random",
                              device=dev)
    zero_launch_counts()
    tp = trainer_phase(
        dev, dict(num_motions=4, num_views=3, num_frames=5, ref_size=512,
                  n_gauss=60, seed=0), TRAINER_OPT, S1_ITERS, S2_ITERS,
        SNAPSHOT_EVERY, INTERRUPT_AT, lpips_fn=trainer_lpips)
    tiles.WINDMA = 0
    tr_launch = {"K1 ch7": cs.launches["ch7"], "K2": sg.launches,
                 "K3": cs.launches["bwd"], "K4": sg.bwd_launches,
                 "K7": wd.launches, "row scatter": rg.launches}
    renders = tp["steps"] * tp["renders_per_step"]
    renders_s2 = tp["s2_steps"] * tp["renders_per_step"]
    want = {"K1 ch7": renders, "K3": renders, "K7": renders,
            "K2": renders_s2, "K4": renders_s2, "row scatter": renders}
    if tr_launch != want or cs.launches["ch3"]:
        fail(f"trainer launches {tr_launch} (ch3 {cs.launches['ch3']}), "
             f"expected {want}")
    print(f"trainer path: {tp['steps']} steps of {tp['renders_per_step']} "
          f"renders ({tp['s2_steps']} in s2); s1 {S1_ITERS} iters: "
          f"n_active by step {tp['n_at']}; {tp['k']} control points -> "
          f"{tp['n_s2']} Gaussians in s2, {tp['n_final']} after the prunes; "
          f"interrupted at {INTERRUPT_AT}, resumed at s2 step "
          f"{tp['resumed_at']}; s1 loss {tp['loss_s1'][0]:.1f} -> "
          f"{tp['loss_s1'][1]:.1f} (mean of first/last 5), last s2 loss "
          f"{tp['loss_s2_last']:.1f}")
    print(f"trainer s1 losses: {tp['losses_s1']}; LPIPS s1 "
          f"{tp['lpips_s1'][0]:.4g} -> {tp['lpips_s1'][1]:.4g}, last s2 "
          f"{tp['lpips_s2_last']:.4g}")
    print("trainer ms/step (CUDA events, cadence work included; mean, steps): "
          + " ".join(f"{k}={v[0]:.1f}x{v[1]}"
                     for k, v in tp["ms_per_step"].items())
          + f"; stage seconds s1={tp['stage_s']['s1']:.2f} "
          f"s2={tp['stage_s']['s2']:.2f}; synthetic videos "
          f"{tp['synth_s']:.2f} s; phase wall {tp['wall_s']:.1f} s; launches "
          f"{tr_launch}")

    # --- 7b. twin trainers: one cut run, twice, the same bits -------------
    torch.cuda.empty_cache()
    zero_launch_counts()
    tw = twin_trainer_phase(
        dev, dict(num_motions=4, num_views=3, num_frames=5, ref_size=512,
                  n_gauss=60, seed=0), TRAINER_OPT, *TWIN_ITERS,
        lpips_fn=trainer_lpips)
    print_twin(tw)
    tw_launch = launch_counts()
    n1, n2 = (sum(1 for e in tw["losses"][0] if e[0] == st)
              for st in ("s1", "s2"))
    if (n1, n2) != TWIN_ITERS or tw["stage"] != "s2":
        fail(f"phase 7b: the runs took {n1} s1 and {n2} s2 steps and ended "
             f"in {tw['stage']}, expected {TWIN_ITERS} and s2")
    r7b = 2 * (n1 + n2) * tp["renders_per_step"]
    r7b_s2 = 2 * n2 * tp["renders_per_step"]
    want = {"K1 ch7": r7b, "K3": r7b, "row scatter": r7b, "K2": r7b_s2,
            "K4": r7b_s2}
    if any(tw_launch[k] != v for k, v in want.items()):
        fail(f"phase 7b launches {tw_launch}, expected {want}")
    if tw["first_diff"] is not None or tw["diff"] or \
            tw["n_active"][0] != tw["n_active"][1]:
        fail("phase 7b: two trainers with one seed gave different bits")

    # --- 8. the tile-compositor path at full width -----------------------
    torch.cuda.empty_cache()
    tile = tile_path_phase(dev)
    tl_launch = tile["launch"]

    # --- 9. the test modes and the CLIs at full width --------------------
    torch.cuda.empty_cache()
    p9 = test_modes_phase(dev, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "build", "phase9"))
    print(f"phase 9 cuts (the reference's in brackets): test_motion "
          f"{FT_ITERS} iterations (1000), test_unaligned_motion "
          f"{FT_ITERS_A} + {FT_ITERS_B} (400 + 1000), the train CLI "
          f"{TRAIN_CLI_ITERS[0]} s1 + {TRAIN_CLI_ITERS[1]} s2 iterations "
          "(1500 + 5000); not cut: the flagship checkpoint (100,000 "
          "Gaussians, 512 control points, 4 latents, latent 32), "
          "test_config.yaml's 800^2, 21 frames, 9 views, ref_size 576, "
          f"tile_capacity 512, batch_size 4, {FPS_HARNESS_ROUNDS} fps rounds "
          "at 512^2, the synthetic motion's 9 views x 21 frames at 576^2, the "
          "train CLI's train_config.yaml widths (2 synthetic motions)")
    print("phase 9 card vs CPU render_sequence (small scene, 5 orbit "
          "frames): " + "; ".join(
              f"{k}^2 max {v[0]} LSB, {v[1]} px over 1 LSB"
              for k, v in p9["small"].items()))
    print("phase 9 wall seconds: " + " ".join(
        f"{k}={v:.2f}" for k, v in p9["walls"].items())
        + f"; phase {p9['wall_s']:.1f} s; synthetic motion made, written "
        f"and read back {p9['motion_s']:.2f} s; {p9['frames']} frames "
        f"checked finite, {p9['videos']} videos")
    print("phase 9 render_sequence ms/frame (CUDA events, KNN once a "
          "sequence, frames copied to the host): " + " ".join(
              f"{k}={v:.2f}" for k, v in p9["seq_ms_by_mode"].items()))
    p3 = p9["plots_3d"]
    print(f"phase 9 3-D track videos ({len(p3)}, every one checked; "
          "(frames, control points), host clock): ms per 3-D frame "
          + " ".join(f"{m}{list(sh[:2])}={ms:.2f}" for m, sh, ms, _ in p3)
          + f"; points hidden by a later marker {sum(h for *_, h in p3)} of "
          f"{sum(sh[0] * sh[1] for _, sh, _, _ in p3)}; {card}")
    ft_ms = p9["ft"]["run_test_motion"]["step_ms"]
    print(f"phase 9 fine-tuning (latent only, LPIPS on, 1 x 5 x 4 = 20 "
          f"renders a step): ms/step at 128^2 / 256^2 / 512^2 "
          + " / ".join(f"{p9['res_ms'][r]:.1f}" for r in (128, 256, 512))
          + f" (CUDA events, mean of {FT_RES_STEPS} after one warm-up); "
          f"test_motion's own steps at 128^2: "
          + ", ".join(f"{x:.1f}" for x in ft_ms) + " ms; losses "
          + json.dumps({k: v["losses"] for k, v in p9["ft"].items()}))
    up = p9["uploads"]["default"]
    print(f"phase 9 dataset upload (`Trainer._upload_dataset` of the test "
          f"CLI's zeros, {up['bytes'] / 2**30:.3f} GiB, host clock between "
          f"synchronizes): default {up['s'] * 1e3:.1f} ms; by mode "
          + " ".join(f"{k}={v['s'] * 1e3:.1f}"
                     for k, v in p9["uploads"].items())
          + f" ms; the fps harness (capacity 512) {p9['fps']:.2f} frames/s")

    # --- 10. native batch I/O, the parallel paths, the quality run -------
    torch.cuda.empty_cache()
    p10 = phase10(dev, card)

    # --- bench: bench_torch.py's functions, fewer rounds ---------------
    torch.cuda.empty_cache()
    cs.launches = dict.fromkeys(cs.launches, 0)
    scene = flagship_scene(device=dev)
    with torch.no_grad():
        knn = find_knn(scene[1], scene[2])
    bench = bench_torch.result_line(
        bench_torch.timed_fps(scene, knn, 3, BENCH_ROUNDS, CAPACITY),
        bench_torch.timed_fps(scene, knn, 7, BENCH_ROUNDS // 2, CAPACITY),
        bench_torch.timed_fps(scene, knn, 3, BENCH_ROUNDS // 2, 512),
        bench_torch.capacity_delta(scene, knn),
        bench_torch.scene_hash(scene[1]), bench_torch.selfcheck(dev), card)
    bench_ch3 = cs.launches["ch3"]
    if not bench["selfcheck_ok"]:
        fail(f"bench selfcheck: {bench}")
    if bench_ch3 != 2 + BENCH_ROUNDS + BENCH_ROUNDS // 2 + 2:
        fail(f"bench: K1 ch3 launched {bench_ch3} times")
    print(f"bench ({BENCH_ROUNDS} ch3 rounds, not bench_torch.py's "
          f"{bench_torch.ROUNDS}): " + json.dumps(bench))
    print(f"serving frames/s at 512^2, ch3: the fps harness "
          f"(`run_test_fps`, capacity 512, {FPS_HARNESS_ROUNDS} rounds) "
          f"{p9['fps']:.2f}; bench_torch's timed_fps at capacity "
          f"{CAPACITY} {bench['value']:.2f} and at 512 "
          f"{bench['fps_cap512']:.2f} ({BENCH_ROUNDS} / {BENCH_ROUNDS // 2} "
          f"rounds); {card}")

    # --- kernels line, card, device --------------------------------------
    def bound(ops: float, nbytes: float) -> dict:
        t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_BW * 1e3
        return {"bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def k1_row(ch: int, key: str) -> dict:
        r = k1[ch]
        return {"name": f"composite_strips_fwd_{key}", "route": "cuda",
                "source": "dimo_tpu_torch/csrc/composite_strips.cu",
                "replaces": "dimo_tpu/ops/rasterizer/composite_strips.py:326",
                "launches": k1_launch[key],
                "launches_trainer": tr_launch.get(f"K1 {key}", 0),
                "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                **bound(r["ops"], r["bytes"]), "library_ms": None,
                "graph_ms": r["graph_ms"],
                "bound_every_pair_ms": bound(r["dense_ops"],
                                             r["bytes"])["bound_ms"],
                "blocks_per_sm": r["blocks_per_sm"],
                "entries": r["entries"], "pixel_entry_pairs": r["pairs"],
                "pairs_alpha_nonzero": r["live"]}

    # launches: on the training path with LPIPS on (this slice's main
    # path) for the kernels it runs, with the serving path's and the
    # LPIPS-off step's counts beside them
    ch7 = k1_row(7, "ch7")
    ch7.update(launches=lp_launch["K1 ch7"], launches_render=k1_launch["ch7"],
               launches_no_lpips=train_launch["K1 ch7"])
    ch3 = k1_row(3, "ch3")
    ch3.update(launches_bench=bench_ch3)
    rows = [ch7, ch3,
            {"name": "gather_small_cols_fwd", "route": "cuda",
             "source": "dimo_tpu_torch/csrc/smallgather.cu",
             "replaces": "dimo_tpu/ops/smallgather.py:200",
             "launches": lp_launch["K2"],
             "launches_no_lpips": train_launch["K2"], "launches_render": k2_launch,
             "launches_trainer": tr_launch["K2"],
             "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
             **bound(0.0, k2_bytes), "library_ms": k2_lib,
             "graph_ms": k2_graph, "library_graph_ms": k2_lib_graph,
             "fill_output_graph_ms": k2_fill},
            {"name": "composite_strips_bwd", "route": "cuda",
             "source": "dimo_tpu_torch/csrc/composite_strips.cu",
             "replaces": "dimo_tpu/ops/rasterizer/composite_strips.py:394",
             "launches": lp_launch["K3"],
             "launches_no_lpips": train_launch["K3"],
             "launches_trainer": tr_launch["K3"], "max_abs_err": k3_err,
             "max_rel_lane_err": k3_rel, "ms": k3_ms, "plain_ms": k3_plain,
             **bound(k3_ops, k3_bytes), "library_ms": None,
             "graph_ms": k3_graph,
             "bound_every_pair_ms": bound(k3_entries * 32 * 32 * K3_OPS,
                                          k3_bytes)["bound_ms"],
             "blocks_per_sm": occ["bwd"], "entries": k3_entries,
             "pixel_entry_pairs": pairs7, "pairs_alpha_nonzero": live7},
            {"name": "gather_small_cols_bwd", "route": "cuda",
             "source": "dimo_tpu_torch/csrc/smallgather.cu",
             "replaces": "dimo_tpu/ops/smallgather.py:212",
             "launches": lp_launch["K4"],
             "launches_no_lpips": train_launch["K4"],
             "launches_trainer": tr_launch["K4"], "max_abs_err": k4_err,
             "ms": k4_ms, "plain_ms": k4_plain, **bound(0.0, k4_bytes),
             "library_ms": k4_lib, "graph_ms": k4_graph,
             "library_graph_ms": k4_lib_graph, "k4_route": route4,
             "grid": grid4, "bit_identical": k4_identical,
             "ptxas": [ptx4["K4 block"], ptx4["K4 combine"],
                       ptx4["K4 sorted tiles"], ptx4["K4 sorted runs"]],
             "blocks_per_sm": [occ4["K4 block"], occ4["K4 combine"]]},
            {"name": "gather_rows_bwd", "route": "cuda",
             "source": "dimo_tpu_torch/csrc/smallgather.cu",
             "replaces": "none (port-only: dimo_tpu/ops/rasterizer/"
                         "gather.py:34 is XLA's sort + cumsum, no TPU kernel)",
             "launches": lp_launch["row scatter"],
             "launches_no_lpips": train_launch["row scatter"],
             "launches_trainer": tr_launch["row scatter"],
             "max_abs_err": scat["err"], "ms": scat["ms"],
             "plain_ms": scat["plain_ms"], **bound(0.0, scat["bytes"]),
             "library_ms": scat["lib_ms"], "graph_ms": scat["graph_ms"],
             "library_graph_ms": scat["lib_graph_ms"],
             "bit_identical": True, "ptxas": scat["ptxas"],
             "slots": scat["slots"], "dummy_slots": scat["dummy_slots"]},
            {"name": "gather_windows", "route": "cuda",
             "source": "dimo_tpu_torch/csrc/windowdma.cu",
             "replaces": "dimo_tpu/ops/rasterizer/windowdma.py:35",
             "launches": tr_launch["K7"], "launches_trainer": tr_launch["K7"],
             "max_abs_err": k7_err, "ms": k7_ms, "plain_ms": k7_plain,
             **bound(0.0, k7_bytes), "library_ms": k7_lib,
             "graph_ms": k7_graph, "library_graph_ms": k7_lib_graph,
             "launch_floor_graph_ms": launch_floor,
             "binning_ms_gather": route_ms[0], "binning_ms_k7": route_ms[1]}]
    def tile_row(key: str, name: str, line: int) -> dict:
        r = tile_res[int(key[-1]) if key.startswith("K8") else "bwd"]
        return {"name": name, "route": "cuda",
                "source": "dimo_tpu_torch/csrc/composite_tiles.cu",
                "replaces": f"dimo_tpu/ops/rasterizer/composite_pallas.py:{line}",
                "launches": tl_launch[key], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                **bound(r["ops"], r["bytes"]), "library_ms": None,
                "graph_ms": r["graph_ms"],
                "bound_every_pair_ms": bound(r["dense_ops"],
                                             r["bytes"])["bound_ms"],
                "ptxas": r["ptxas"], "blocks_per_sm": r["blocks_per_sm"],
                "entries": tile_res["entries"],
                "pixel_entry_pairs": tile_res["pairs"],
                **({"pairs_in_box": tile_res["in_box"]}
                   if key.startswith("K8") else {}),
                "pairs_alpha_nonzero": tile_res["live"]}

    def rows_row(key: str, name: str, line: int) -> dict:
        r = rows_res[key.lower()]
        return {"name": name, "route": "cuda",
                "source": "dimo_tpu_torch/csrc/smallgather.cu",
                "replaces": f"dimo_tpu/ops/smallgather.py:{line}",
                "launches": tl_launch[key], "max_abs_err": r["err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], **bound(0.0, r["bytes"]),
                "library_ms": r["lib_ms"], "graph_ms": r["graph_ms"],
                "library_graph_ms": r["lib_graph_ms"], "ptxas": r["ptxas"],
                "blocks_per_sm": r["blocks_per_sm"],
                **{k: r[k] for k in ("k6_route", "bit_identical", "grid")
                   if k in r}}

    for row in rows:
        if row["name"] in ("gather_small_cols_fwd", "gather_small_cols_bwd",
                           "gather_rows_bwd"):
            row["launches_tile_path"] = tl_launch[
                {"gather_small_cols_fwd": "K2", "gather_small_cols_bwd": "K4",
                 "gather_rows_bwd": "row scatter"}[row["name"]]]
    tile_bwd = tile_row("K9", "composite_tiles_bwd", 280)
    tile_bwd.update(max_rel_lane_err=tile_res["bwd"]["rel"])
    rows += [rows_row("K5", "gather_small_rows_fwd", 68),
             rows_row("K6", "gather_small_rows_bwd", 83),
             *(tile_row(f"K8 ch{ch}", f"composite_tiles_fwd_ch{ch}", 205)
               for ch in (7, 4, 3)), tile_bwd]
    counter_of = {"composite_strips_fwd_ch7": "K1 ch7",
                  "composite_strips_fwd_ch3": "K1 ch3",
                  "gather_small_cols_fwd": "K2", "composite_strips_bwd": "K3",
                  "gather_small_cols_bwd": "K4", "gather_windows": "K7",
                  "gather_rows_bwd": "row scatter",
                  "gather_small_rows_fwd": "K5", "gather_small_rows_bwd": "K6",
                  "composite_tiles_fwd_ch7": "K8 ch7",
                  "composite_tiles_fwd_ch4": "K8 ch4",
                  "composite_tiles_fwd_ch3": "K8 ch3",
                  "composite_tiles_bwd": "K9"}
    for row in rows:
        if row["name"] not in counter_of:
            fail(f"kernels line: row {row['name']} has no launch counter")
        key = counter_of[row["name"]]
        row["launches_test_modes"] = {m: c[key]
                                      for m, c in p9["launches"].items()}
        # null: a run that does not count that kernel
        row["launches_phase10"] = {m: c.get(key)
                                   for m, c in p10["launches"].items()}
    print(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"fps_ch3": fps,
                      "seq_ch7_frames_per_s": SEQ_FRAMES / seq_s,
                      "train_step_ms": step_ms, "train_split_ms": split,
                      "train_peak_gib": peak_no_lp,
                      "train_lpips_step_ms": step_lp_ms,
                      "train_lpips_split_ms": split_lp,
                      "train_lpips_peak_gib": peak_lp,
                      "lpips_tf32_vs_float32": {
                          k: v for k, v in prec.items() if k != "dist_f32"},
                      "lpips_step_busy": {k: v for k, v in busy.items()
                                          if k != "by_name"},
                      "bench": bench,
                      "trainer_ms_per_step": tp["ms_per_step"],
                      "trainer_stage_s": tp["stage_s"],
                      "trainer_wall_s": tp["wall_s"],
                      "tile_path_stage_ms": tile["stage_ms"],
                      "tile_path_fwd_bwd_ms": tile["fb_ms"],
                      "tile_path_ch3_ms": tile["infer_ms"],
                      "tile_path_entries_listed": tile["entries_listed"],
                      "tile_path_entries_dropped": tile["entries_dropped"],
                      "tile_path_image_vs_capacity_4096": tile["capacity_delta"],
                      "tile_vs_strip_max_err": tile["cross_err"],
                      "tile_vs_strip_grad_rel_l2": tile["cross_grad"],
                      "train_step_spread": spread,
                      "test_modes_wall_s": p9["walls"],
                      "test_modes_seq_ms_per_frame": p9["seq_ms_by_mode"],
                      "test_modes_3d_ms_per_frame": [
                          [m, ms] for m, _, ms, _ in p9["plots_3d"]],
                      "test_fps_harness": p9["fps"],
                      "finetune_step_ms": p9["res_ms"],
                      "test_cli_uploads": p9["uploads"],
                      "phase10": p10["summary"]}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
