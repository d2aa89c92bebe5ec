"""The readers of the program's own spans (`harness/spans.py`, the
`host_reads`, `host_read_ms`, `packer_wait_ms` and `host_busy_ms`
metrics) over a tiny traced `s2-train-lpips` run on the CPU, and, on a
card, that every synchronizing call of a traced step lies inside one of
the program's `host_read` spans."""
from __future__ import annotations

import time
import traceback
import warnings

import pytest

from conftest import tiny_cell
from harness import spec as spec_mod

NEW = ("host_reads", "host_read_ms", "packer_wait_ms", "host_busy_ms")
LOOSE = {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the process (a marked step turns it on for
    good), and the dataset on the host route, through the packer."""
    from dimo_tpu_torch.utils import diagnostics
    rec = diagnostics.Recorder()
    monkeypatch.setattr(diagnostics, "RECORDER", rec)
    monkeypatch.setenv("DIMO_DEVICE_DATA", "0")
    return rec


def test_a_traced_run_reads_all_eight(recorder, tmp_path):
    cell = tiny_cell("s2-train-lpips", LOOSE)
    drv = spec_mod.load_module("drivers", "train_loop")
    out = drv.run(cell, 2**31 + 11, 0.5, True, "cpu", str(tmp_path),
                     time.perf_counter())
    rec = out["record"]
    n = rec["train"]["steps"]
    got = {f"{m}.{s}": spec_mod.load_module("metrics", f"{m}.{s}").read(rec)
           for m in NEW for s in ("train", "s1")}
    assert all(isinstance(v, float) for v in got.values()), got
    for m in NEW:
        assert got[f"{m}.train"] == got[f"{m}.s1"]
    # the step's three parts add up to its span, and the spans lie inside
    # the window's steps on the host clock
    step_ms = [g[0].host_ms for g in recorder.completed_steps(n)]
    assert got["host_busy_ms.train"] + got["host_read_ms.train"] \
        + got["packer_wait_ms.train"] == pytest.approx(sum(step_ms) / n)
    assert sum(step_ms) <= 1e3 * sum(rec["train"]["step_s"])
    # 2 renders (1 frame x 1 view x 2 motions) in one pass and the VGG's
    # LPIPS: the sites of tests/test_torch_trace.py's `expected_sites`,
    # and `lpips_norm`'s two
    assert got["host_reads.train"] == 45 + 2
    # the per-layer line of the traced run carries them
    line = spec_mod.read_metrics(cell["per_layer"], rec)
    assert {f"{m}.train" for m in NEW} <= set(line)


def test_a_traced_run_reads_the_losses_and_adam_segments(recorder,
                                                        tmp_path):
    """`losses_ms` and `adam_ms` read floats from the window's marks; on
    the CPU no device is traced, so `lpips_roofline_pct` finds nothing."""
    cell = tiny_cell("s2-train-lpips", LOOSE)
    drv = spec_mod.load_module("drivers", "train_loop")
    rec = drv.run(cell, 2**31 + 13, 0.5, True, "cpu", str(tmp_path),
                  time.perf_counter())["record"]
    for s in ("train", "s1"):
        for m in ("losses_ms", "adam_ms"):
            v = spec_mod.load_module("metrics", f"{m}.{s}").read(rec)
            assert isinstance(v, float) and v > 0, (m, v)
        assert spec_mod.load_module(
            "metrics", f"lpips_roofline_pct.{s}").read(rec) is None
    assert rec["work"]["lpips_flops"] > 0
    line = spec_mod.read_metrics(cell["per_layer"], rec)
    assert {"losses_ms.train", "adam_ms.train"} <= set(line)


def test_without_the_recorder_the_readers_find_nothing(recorder,
                                                       monkeypatch):
    """The parent's program has no recorder: the readers return None and
    do not raise; so does a run that kept fewer steps."""
    from dimo_tpu_torch.utils import diagnostics
    rec = {"train": {"steps": 3}}
    readers = [spec_mod.load_module("metrics", f"{m}.{s}").read
               for m in NEW for s in ("train", "s1")]
    assert [r(rec) for r in readers] == [None] * 8
    monkeypatch.delattr(diagnostics, "step_totals")
    assert [r(rec) for r in readers] == [None] * 8
    assert [r({}) for r in readers] == [None] * 8


def test_every_sync_of_a_traced_step_is_a_host_read(card, recorder,
                                                    tmp_path):
    """One traced step of the tiny cell on the card under
    `torch.cuda.set_sync_debug_mode("warn")`: each warning of a
    synchronizing call comes while a `host_read` span is the innermost
    open span."""
    import torch
    from dimo_tpu_torch.utils import diagnostics
    cell = tiny_cell("s2-train-lpips", LOOSE)
    drv = spec_mod.load_module("drivers", "train_loop")
    s = drv.setup(cell["config"], cell["traffic"], 2**31 + 7, card,
                     str(tmp_path), True, time.perf_counter())
    assert recorder.on
    outside, warned = [], set()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return                   # e.g. the mode's own warning
        top = recorder._stack[-1] if recorder._stack else None
        if top is not None and top.name == "host_read":
            warned.add(id(top))
        else:
            outside.append("".join(traceback.format_stack(limit=12)))
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            s["tr"].train_step_once(s["lpips_fn"])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    drv.release(s, card)
    (spans,) = recorder.completed_steps(1)
    reads = [x for x in spans if x.name == "host_read"]
    quiet = sorted({x.site for x in reads if id(x) not in warned})
    sites = diagnostics.step_totals(1)[0]["sites"]
    print(f"{len(reads)} host_read spans, {len(warned)} warned, "
          f"{len(outside)} syncs outside; sites {sites}")
    assert not outside, f"{len(outside)} outside:\n" + "\n".join(
        sorted(set(outside))[:10])
    # each span but the packer's wait on its event (which the debug mode
    # does not see) holds a synchronizing call
    assert quiet == ["packer_slot"]
