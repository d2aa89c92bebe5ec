"""The device trace filed by segment (`harness/trace.py::summary`) on a
hand-made trace, the names the breakdown prints for kernels recorded on
the card, and the readers of the segment metrics (`lpips_roofline_pct`,
`losses_ms`, `adam_ms`)."""
from __future__ import annotations

import json
import os
from types import SimpleNamespace

import pytest
import torch

from harness import spec as spec_mod
from harness import trace
from work.peaks import FP32

NEW = ("lpips_roofline_pct", "losses_ms", "adam_ms")
HERE = os.path.dirname(os.path.abspath(__file__))


class Event:
    """A CUDA event's stand-in at `t` microseconds."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e-3


def stretch(acts: list, marks: list, spins: list):
    events = [SimpleNamespace(
        time_range=SimpleNamespace(start=a, end=b), name=name,
        device_type=torch.autograd.DeviceType.CUDA)
        for a, b, name in acts + [s + (trace.MARKER,) for s in spins]]
    events.append(SimpleNamespace(          # a host operator: not read
        time_range=SimpleNamespace(start=0.0, end=900.0), name="aten::mm",
        device_type=torch.autograd.DeviceType.CPU))
    return SimpleNamespace(
        prof=SimpleNamespace(events=lambda: events), start=Event(0.0),
        marks=[(label, Event(t)) for t, label in marks], tail="trainer",
        host_s=1.5e-3)


# microseconds: a step's segments closed by marks, the stretch (0, 1000)
# between two pairs of spins
MARKS = [(100.0, "trainer"), (150.0, "sample_batch"), (400.0, "renders"),
         (600.0, "lpips"), (700.0, "losses"), (900.0, "backward"),
         (950.0, "adam")]
ACTS = [(10.0, 90.0, "a"), (110.0, 140.0, "copy"), (160.0, 300.0, "r"),
        (300.0, 400.0, "r"),            # ends as the stream reaches the mark
        (402.0, 598.0, "conv"), (605.0, 690.0, "mul"), (705.0, 890.0, "conv"),
        (800.0, 850.0, "mul"),          # a second stream, inside the first
        (905.0, 940.0, "adam"), (960.0, 1010.0, "a")]    # cut at the end
SPINS = [(-200.0, -100.0), (-100.0, 0.0), (1000.0, 1001.0), (1001.0, 1002.0)]


def test_each_activity_lands_in_its_segment():
    out = trace.summary(stretch(ACTS, MARKS, SPINS))
    segs = out["by_segment"]
    assert {seg: {k: round(v * 1e6, 6) for k, v in x["kernels"].items()}
            for seg, x in segs.items()} == {          # microseconds
        "trainer": {"a": 120}, "sample_batch": {"copy": 30},
        "renders": {"r": 240}, "lpips": {"conv": 196}, "losses": {"mul": 85},
        "backward": {"conv": 185, "mul": 50}, "adam": {"adam": 35}}
    assert segs["backward"]["busy_s"] == pytest.approx(185e-6)   # the union
    assert sum(v["busy_s"] for v in segs.values()) == pytest.approx(
        out["busy_s"], rel=1e-12)
    # a mark read a little early on the events' clock: the middle decides
    assert trace.segment_of(MARKS, 300.0, 400.6, "trainer") == "renders"
    assert trace.segment_of(MARKS, 400.6, 403.0, "trainer") == "lpips"
    assert trace.segment_of(MARKS, 951.0, 960.0, "trainer") == "trainer"
    ops = out["breakdown"]["device_ops"]
    assert ops == [["renders:r", pytest.approx(240e-6)],
                   ["lpips:conv", pytest.approx(196e-6)],
                   ["backward:conv", pytest.approx(185e-6)],
                   ["trainer:a", pytest.approx(120e-6)],
                   ["losses:mul", pytest.approx(85e-6)],
                   ["backward:mul", pytest.approx(50e-6)],
                   ["adam:adam", pytest.approx(35e-6)],
                   ["sample_batch:copy", pytest.approx(30e-6)]]


def test_the_earlier_readings_stay_as_they_were():
    """busy_s, window_s, host_s, by_name and the idle gaps as the summary
    gave them before it filed activities by segment (worked by hand)."""
    out = trace.summary(stretch(ACTS, MARKS, SPINS))
    assert out["busy_s"] == pytest.approx(891e-6, rel=1e-12)
    assert out["window_s"] == pytest.approx(1000e-6, rel=1e-12)
    assert out["host_s"] == 1.5e-3
    assert out["by_name"] == pytest.approx({
        "a": 120e-6, "copy": 30e-6, "r": 240e-6, "conv": 381e-6,
        "mul": 135e-6, "adam": 35e-6}, rel=1e-12)
    gaps = out["breakdown"]["idle_gaps"]
    assert [g[0] for g in gaps] == ["trainer", "sample_batch", "adam",
                                    "losses", "backward", "trainer",
                                    "lpips", "lpips"]
    assert [g[1] for g in gaps] == pytest.approx(
        [20e-6, 20e-6, 20e-6, 15e-6, 15e-6, 10e-6, 7e-6, 2e-6], rel=1e-9)


def metric(name, rec):
    return spec_mod.load_module("metrics", name).read(rec)


@pytest.mark.parametrize("name", [f"{m}.{s}" for m in NEW
                                  for s in ("train", "s1")])
def test_the_new_readers_find_nothing_without_their_keys(name):
    """The parent's record has no `by_segment`, no `lpips_flops`; a run
    without marks has no segments: None, and no exception."""
    parent = {"device": "cuda", "train": {"steps": 3, "window_s": 3.0,
                                          "segments": []},
              "trace": {"busy_s": 0.5, "window_s": 0.6, "host_s": 0.6,
                        "by_name": {"k": 0.5}, "steps": 2},
              "work": {"k3": [], "step_flops": 1e12}}
    for rec in ({}, {"train": None, "trace": None}, parent,
                {"train": {"segments": [{"renders": 0.1}]}},
                {"trace": {"by_segment": {"lpips": {"busy_s": 0.0}}},
                 "work": {"lpips_flops": 1e12}}):
        assert metric(name, rec) is None


def test_the_new_readers_read_their_segments():
    rec = {"device": "cuda",
           "train": {"steps": 2, "window_s": 2.0, "segments": [
               {"renders": 0.1, "lpips": 0.2, "losses": 0.03, "backward": 0.4,
                "adam": 0.005},
               {"renders": 0.1, "lpips": 0.2, "losses": 0.05, "backward": 0.4,
                "adam": 0.007}]},
           "trace": {"by_segment": {"lpips": {"busy_s": 0.5, "kernels": {}}}},
           "work": {"lpips_flops": 0.25 * FP32}}
    assert metric("losses_ms.train", rec) == pytest.approx(40.0)
    assert metric("adam_ms.train", rec) == pytest.approx(6.0)
    assert metric("lpips_roofline_pct.train", rec) == pytest.approx(50.0)


def test_recorded_kernel_names_compact_apart():
    """Full names of device activities recorded in traced runs of both
    cells on an H100 (the five the ledger's 64 characters merged among
    them): under the longest segment's prefix each name keeps its
    operation, fits in 64 characters, and no two kernels share one."""
    with open(os.path.join(HERE, "kernel_names.json")) as f:
        full = json.load(f)
    names = trace.op_names([("sample_batch", n) for n in full])
    assert all(len(n) <= trace.NAME_LIMIT for n in names)
    assert len(set(names)) == len(full)
    short = dict(zip(full, (n.split(":", 1)[1] for n in names)))
    for op in ("MulFunctor", "CUDAFunctorOnSelf_add"):
        whole = [n for n in full if op in n]
        assert whole and all(op in short[n] for n in whole), op
    # each kernel under the same name in every segment
    pairs = [(seg, n) for n in full for seg in ("lpips", "sample_batch")]
    two = trace.op_names(pairs)
    assert all(a.split(":", 1)[1] == b.split(":", 1)[1]
               for a, b in zip(two[::2], two[1::2]))
