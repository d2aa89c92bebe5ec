"""The `s2b4-train-lpips` cell's driver (`drivers/train_loop_blocks.py`,
the reference a motion at a time) on the CPU at a tiny size: a sound run
is correct, one with its state left unchanged or half of its batch left
out is not; a traced run counts LPIPS's whole work and reads the
program's LPIPS chunks; the `.b4` readers find nothing in a record of a
program without the chunk counter."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from conftest import ROOT, TINY
from harness import spec as spec_mod
from test_bench_faults import half_batch, unchanged_state
from work import vgg16

B4 = ("lpips_chunks.b4", "lpips_ms.b4", "backward_ms.b4",
      "lpips_roofline_pct.b4", "mfu_pct.b4")


def tiny_b4() -> dict:
    """`s2b4-train-lpips` at `dimo-s2`'s tiny size, 2 motions x 2 views x
    2 frames a step."""
    spec = spec_mod.load_spec(ROOT)
    cell = copy.deepcopy(spec_mod.cell(spec, "s2b4-train-lpips", ROOT))
    cell["config"].update(copy.deepcopy(TINY["dimo-s2"]))
    cell["config"]["batch_size"] = 2
    cell["config"]["scene"]["num_motions"] = 2
    return cell


def run(cell, tmp_path, trace=False, seed=2**31 + 21):
    drv = spec_mod.load_module("drivers", cell["traffic"]["driver"])
    return drv.run(cell, seed, 0.1, trace, "cpu", str(tmp_path),
                   time.perf_counter())


@pytest.mark.parametrize("fault", [None, "unchanged_state", "half_batch"])
def test_b4_faults(fault, monkeypatch, tmp_path):
    torch.set_num_threads(4)
    if fault:
        {"unchanged_state": unchanged_state,
         "half_batch": half_batch}[fault](monkeypatch)
    out = run(tiny_b4(), tmp_path)
    assert out["correct"] is (fault is None), out["checks"]


def test_a_traced_b4_run_counts_the_whole_lpips_work(monkeypatch, tmp_path):
    from dimo_tpu_torch.utils import diagnostics
    torch.set_num_threads(4)
    monkeypatch.setattr(diagnostics, "RECORDER", diagnostics.Recorder())
    cell = tiny_b4()
    rec = run(cell, tmp_path, trace=True)["record"]
    # 8 renders at 128^2, 2 profiled steps: both towers and the input VJP
    assert rec["work"]["lpips_flops"] == 2 * vgg16.lpips_step_flops(8, 128,
                                                                   128)
    line = spec_mod.read_metrics(cell["per_layer"], rec)
    # at 128^2 one LPIPS call holds the whole batch; on the CPU nothing
    # is traced on a device, so the roofline and MFU find nothing
    assert line["lpips_chunks.b4"]["value"] == 1
    assert line["lpips_ms.b4"]["value"] > 0
    assert line["backward_ms.b4"]["value"] > 0
    assert "lpips_roofline_pct.b4" not in line and "mfu_pct.b4" not in line


def test_the_b4_readers_find_nothing_without_the_counter(monkeypatch):
    from dimo_tpu_torch.utils import diagnostics
    monkeypatch.setattr(diagnostics, "RECORDER", diagnostics.Recorder())
    rec = {"train": {"steps": 3}, "device": "cpu"}
    readers = [spec_mod.load_module("metrics", m).read for m in B4]
    assert [r(rec) for r in readers] == [None] * 5
    monkeypatch.delattr(diagnostics, "step_totals")
    assert readers[0](rec) is None
