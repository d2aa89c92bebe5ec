"""The reader of the program's render-pass counters
(`renders_per_pass.train`, `renders_per_pass.s1`) over a tiny traced
`s2-train-lpips` run on the CPU, and None from a program whose recorder
has no such counters or that has no recorder."""
from __future__ import annotations

import time

import pytest

from conftest import tiny_cell
from harness import spec as spec_mod

LOOSE = {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}
NAMES = ("renders_per_pass.train", "renders_per_pass.s1")


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder for the process (a marked step turns it on for
    good), and the dataset on the host route, through the packer."""
    from dimo_tpu_torch.utils import diagnostics
    rec = diagnostics.Recorder()
    monkeypatch.setattr(diagnostics, "RECORDER", rec)
    monkeypatch.setenv("DIMO_DEVICE_DATA", "0")
    return rec


def readers():
    return [spec_mod.load_module("metrics", n).read for n in NAMES]


def test_a_traced_run_reads_the_jobs_of_the_steps_pass(recorder, tmp_path):
    cell = tiny_cell("s2-train-lpips", LOOSE)
    drv = spec_mod.load_module("drivers", "train_loop")
    out = drv.run(cell, 2**31 + 13, 0.5, True, "cpu", str(tmp_path),
                  time.perf_counter())
    rec = out["record"]
    assert rec["train"]["steps"] >= 1
    # 1 frame x 1 view x 2 motions, one pass a step
    assert [r(rec) for r in readers()] == [2.0, 2.0]
    line = spec_mod.read_metrics(cell["per_layer"], rec)
    assert line["renders_per_pass.train"]["value"] == 2.0
    assert "renders_per_pass.s1" not in line     # not this cell's metric


def test_without_the_counters_the_reader_finds_nothing(recorder,
                                                       monkeypatch):
    """The parent's recorder has no `render_jobs` / `render_passes`, an
    older program no recorder: the readers return None and do not raise;
    so does a run that kept fewer steps."""
    from dimo_tpu_torch.utils import diagnostics
    rec = {"train": {"steps": 2}}
    assert [r(rec) for r in readers()] == [None, None]
    rows = [{"host_reads": 3}, {"host_reads": 4}]
    monkeypatch.setattr(diagnostics, "step_totals", lambda n: rows[-n:])
    assert [r(rec) for r in readers()] == [None, None]
    monkeypatch.delattr(diagnostics, "step_totals")
    assert [r(rec) for r in readers()] == [None, None]
    assert [r({}) for r in readers()] == [None, None]
