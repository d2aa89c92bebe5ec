"""LPIPS in chunks of whole motions (`train/step.py`), on the CPU at tiny
sizes.

The step runs each chunk's renders (whole motions, at most
`LPIPS_PIXELS` pixels) through LPIPS's forward and input VJP together
and hands the summed image gradient to the one backward. Held here: its
loss, LPIPS metric and every leaf's gradient against the same step with
LPIPS over the rank's whole batch in one call and one backward
(`parallel/check.py::lpips_step_pair`), in s1, s2 and with the VAE
latent, with one motion a chunk and with the whole batch in one, and at
data_parallel=2 with a motion split across two gloo ranks; the
recorder's `lpips_chunk` spans and counters; and the
benchmark's blocked reference (`benchmark/reference/step_blocks.py`)
against the program's step under the cell's own limits and against the
whole-batch reference (`reference/step.py`).

Tolerances: 1e-6 relative on the loss and on each leaf's gradient (L2):
the two orders of summation differ by float32 rounding (the images'
gradient summed from the chunks, then added to the other losses'), a few
units of 1e-8 here. The blocked reference's change after three Adam
steps: 1e-4 (read 6e-6 here; Adam's normalised step lifts a leaf's
rounding where its gradient is small).
"""
import copy
import os
import sys
import time

import numpy as np
import pytest
import torch

from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.models.lpips import random_init_lpips
from dimo_tpu_torch.parallel import check
from dimo_tpu_torch.presets import tiny_synthetic_opt
from dimo_tpu_torch.train import step as step_mod
from dimo_tpu_torch.train.loop import Trainer
from dimo_tpu_torch.utils import diagnostics

from torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
ARAP_TIMES = np.linspace(0.05, 0.95, 8).astype(np.float32)
RENDER = 128 * 128             # a render's pixels at the tiny steps
SPAWN_TIMEOUT_S = 240.0
# `s2b4-train-lpips` cut to a size the CPU runs in seconds
TINY_B4 = {"num_cpts": 32, "latent_code_dim": 8, "num_views": 3,
           "num_frames": 5, "ref_size": 64, "batch_size": 1,
           "start_step": 100, "settled_tile_capacity": 256,
           "tile_capacity": 256, "W": 96, "H": 96,
           "scene": {"num_gaussians": 512, "num_motions": 2,
                     "log_scale_shift": 0.6}}


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    n = float(torch.linalg.vector_norm(b))
    d = float(torch.linalg.vector_norm(a - b))
    return d / n if n else d


def trainer(stage: str, tmp_path, **kw) -> Trainer:
    """A Trainer before its next `stage` step: 2 motions x 2 views x 2
    frames (8 renders, 4 a motion) at 128^2."""
    data = make_synthetic_videos(num_motions=2, num_views=3, num_frames=5,
                                 ref_size=64, seed=0, device="cpu")
    opt = tiny_synthetic_opt(save_path=str(tmp_path), batch_size=2, **kw)
    tr = Trainer(opt, *data, device="cpu")
    tr.prepare_train_s1()
    if stage == "s2":
        tr.train_step_once()
        tr.finish_s1()
        tr.prepare_train_s2()
    return tr


def assert_pair_close(chunked: dict, whole: dict) -> None:
    assert rel(chunked["loss"], whole["loss"]) <= 1e-6
    assert chunked["grads"].keys() == whole["grads"].keys()
    moved = 0
    for k, g in whole["grads"].items():
        assert rel(chunked["grads"][k], g) <= 1e-6, k
        moved += bool(g.any())
    assert moved > 5


@pytest.mark.parametrize("stage,kw,renders", [
    ("s2", {}, 4), ("s1", {}, 4), ("s1", {"vae_latent": True}, 4),
    ("s2", {}, None)], ids=["s2", "s1", "vae", "s2-one-chunk"])
def test_chunked_step_is_the_whole_batch_step(tmp_path, monkeypatch, stage,
                                              kw, renders):
    """`renders` a chunk: 4, one motion a chunk; None, the default,
    whose 2**23 pixels hold the whole batch at 128^2."""
    if renders:
        monkeypatch.setattr(step_mod, "LPIPS_PIXELS", renders * RENDER)
    tr = trainer(stage, tmp_path, **kw)
    chunked, whole = check.lpips_step_pair(tr, random_init_lpips(0, "cpu"),
                                           ARAP_TIMES)
    assert_pair_close(chunked, whole)
    assert chunked["lpips"] > 0
    assert rel(chunked["lpips"], whole["lpips"]) <= 1e-6
    if stage == "s1":               # the densification statistics' tap
        assert chunked["grads"]["tap"].any()


def test_chunked_step_at_data_parallel_2(tmp_path):
    """3 motions x 2 views x 2 frames: 12 jobs, 6 a rank, so motion 1
    (jobs 4-7) is split across the ranks and each rank's part of it
    carries half of its mean; chunks of at most 6 renders put a whole
    motion and a part of motion 1 in each rank's one chunk."""
    out = tmp_path / "out"
    out.mkdir()
    kw = {"data": dict(num_motions=3, num_views=3, num_frames=5, ref_size=64,
                       n_gauss=40, seed=0),
          "opt": dict(batch_size=2, save_path=str(tmp_path / "run")),
          "arap_times": ARAP_TIMES.tolist(), "lpips_pixels": 6 * RENDER}
    check.spawn(check.lpips_chunks_worker, 2,
                (str(tmp_path / "rdv"), str(out), kw), SPAWN_TIMEOUT_S)
    for r in range(2):
        z = dict(np.load(out / f"rank{r}.npz"))
        pair = [{"loss": float(z[f"{w}.loss"]),
                 "grads": {k[len(w) + 3:]: torch.from_numpy(v)
                           for k, v in z.items()
                           if k.startswith(f"{w}.g.")}}
                for w in ("chunked", "whole")]
        assert_pair_close(*pair)


def test_chunks_are_spans_and_counters(tmp_path, monkeypatch):
    """One chunk a motion (4 renders a chunk): `lpips_chunks` 2 and
    `lpips_chunk_images` 8 a step, each chunk an `lpips_chunk` span
    inside the `lpips` segment, and LPIPS's constants copied to the
    device once a step."""
    rec = diagnostics.Recorder()
    monkeypatch.setattr(diagnostics, "RECORDER", rec)
    monkeypatch.setattr(step_mod, "LPIPS_PIXELS", 4 * RENDER)
    tr = trainer("s2", tmp_path)
    lp = random_init_lpips(0, "cpu")
    with diagnostics.tracing():
        for _ in range(2):
            tr.train_step_once(lp)
    for spans, tot in zip(rec.completed_steps(2),
                          diagnostics.step_totals(2)):
        assert (tot["lpips_chunks"], tot["lpips_chunk_images"]) == (2, 8)
        assert (tot["render_jobs"], tot["render_passes"]) == (8, 1)
        chunks = [s for s in spans if s.name == "lpips_chunk"]
        assert len(chunks) == 2
        assert {s.parent.name for s in chunks} == {"lpips"}
        assert tot["sites"]["lpips_norm"] == 2


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """The tiny `s2b4-train-lpips` cell's program run (its first three
    steps) and both references' three steps from the same inputs."""
    sys.path.insert(0, BENCH)
    try:
        from harness import checks
        from harness import spec as spec_mod
        spec = spec_mod.load_spec(ROOT)
        cell = copy.deepcopy(spec_mod.cell(spec, "s2b4-train-lpips", ROOT))
        cell["config"].update(copy.deepcopy(TINY_B4))
        drv = spec_mod.load_module("drivers", "train_loop_blocks")
        whole = spec_mod.load_module("drivers", "train_loop")
    finally:
        sys.path.remove(BENCH)
    base, cfg = drv.base, cell["config"]
    s = base.setup(cfg, cell["traffic"], 2**31 + 5, "cpu",
                   str(tmp_path_factory.mktemp("b4")), False,
                   time.perf_counter())
    prog = s["prog"]
    prog["losses"] = [float(x) for x in s["rec"]["losses"][:3]]
    base.release(s, "cpu")
    return {"checks": checks, "limits": cell["limits"], "prog": prog,
            "blocks": base.follow(s, cfg, "cpu", False),
            "whole": whole.follow(s, cfg, "cpu", False)}


def test_the_port_is_the_blocked_reference(blocks):
    checks = blocks["checks"]
    numbers = checks.train_numbers(blocks["prog"], blocks["blocks"])
    correct, rows = checks.judge(numbers, blocks["limits"])
    assert correct, rows


def test_the_blocked_reference_is_the_whole_batch_reference(blocks):
    b, w = blocks["blocks"], blocks["whole"]
    n = blocks["checks"].train_numbers(b, w)
    assert n["loss_gap"][0] <= 1e-6 and n["grad_gap"][0] <= 1e-6, n
    assert n["change_gap"][0] <= 1e-4, n
    np.testing.assert_allclose(b["losses"], w["losses"], rtol=1e-6)
    assert b["rows"] == w["rows"]
