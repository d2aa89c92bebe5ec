"""The arithmetic of the metrics: over a synthetic window a stall moves
the step time and the frame tail, the idle share of a hand-made trace,
and the work counts."""
from __future__ import annotations

import pytest

from harness import spec as spec_mod
from harness import trace
from work import compositor, timenet, vgg16


def metric(name, rec):
    return spec_mod.load_module("metrics", name).read(rec)


def train_window(step_s: list) -> dict:
    return {"device": "cuda", "train": {"steps": len(step_s),
                                        "window_s": sum(step_s),
                                        "peak_bytes": 3 << 30}}


def serve_window(intervals: list) -> dict:
    return {"device": "cuda", "serve": {"frames": len(intervals),
                                        "window_s": sum(intervals),
                                        "intervals": intervals}}


def test_a_stall_moves_the_train_step_time():
    calm = metric("train_step_ms", train_window([1.0] * 20))
    stalled = metric("train_step_ms", train_window([1.0] * 19 + [3.0]))
    assert calm == pytest.approx(1000.0)
    assert stalled == pytest.approx(1100.0)
    assert metric("train_peak_gib", train_window([1.0])) == 3.0


@pytest.mark.parametrize("name", [
    "train_step_ms", "batch_ms.train", "render_ms.train", "lpips_ms.train",
    "backward_ms.train", "device_busy_ms.train", "idle_pct.train",
    "profiled_step_ms.train", "mfu_pct.train", "losses_ms.train",
    "adam_ms.train", "lpips_roofline_pct.train"])
def test_a_per_layer_copy_reads_as_its_original(name):
    rec = train_window([0.5] * 19 + [1.5])
    rec["train"].update(batch_s=[0.01, 0.02], segments=[
        {"renders": 0.2, "lpips": 0.1, "losses": 0.02, "backward": 0.3,
         "adam": 0.004},
        {"renders": 0.4, "lpips": 0.3, "losses": 0.03, "backward": 0.5,
         "adam": 0.006}])
    rec["trace"] = {"busy_s": 0.045, "window_s": 0.3, "host_s": 0.3,
                    "step_ms": 150.0, "steps": 2,
                    "by_segment": {"lpips": {"busy_s": 0.02, "kernels": {}}}}
    rec["work"] = {"step_flops": 2e12, "lpips_flops": 5e11}
    copy = (name[:-len(".train")] if name.endswith(".train") else name) + ".s1"
    assert metric(name, rec) is not None
    assert metric(copy, rec) == metric(name, rec)


def test_a_stall_moves_the_frame_tail():
    calm = [0.025] * 400
    assert metric("frame_ms_p95", serve_window(calm)) == pytest.approx(25.0)
    stalled = calm[:379] + [0.25] * 21
    assert metric("frame_ms_p95", serve_window(stalled)) == pytest.approx(250.0)
    assert metric("frames_per_s", serve_window(calm)) == pytest.approx(40.0)


def test_idle_share_of_a_hand_made_trace():
    device = [(10.0, 30.0, "k1"), (20.0, 40.0, "k2"), (60.0, 70.0, "k1"),
              (95.0, 120.0, "k3")]
    busy, gaps = trace.busy(device, (0.0, 100.0))
    assert busy == pytest.approx(45.0)
    assert gaps == [(0.0, 10.0), (40.0, 60.0), (70.0, 95.0)]
    assert trace.by_name(device, (0.0, 100.0)) == {
        "k1": 30.0, "k2": 20.0, "k3": 5.0}
    marks = [(5.0, "trainer"), (12.0, "sample_batch"), (38.0, "renders"),
             (62.0, "lpips"), (96.0, "backward")]
    assert [trace.name_gap(marks, a, "trainer") for a, _ in gaps] == [
        "trainer", "lpips", "backward"]
    assert trace.name_gap(marks, 97.0, "trainer") == "trainer"
    spins = [(-200.0, -100.0), (-100.0, 0.0), (5e4, 5.01e4),
             (5.01e4, 5.02e4)]                          # microseconds
    assert trace.bounds(spins) == (0.0, 5e4)
    assert trace.bounds(spins[1:3]) == (0.0, 5e4)
    with pytest.raises(ValueError):
        trace.bounds(spins[:2])
    rec = {"train": {"steps": 10, "window_s": 1.0},
           "trace": {"busy_s": 0.045, "window_s": 0.3, "host_s": 0.3,
                     "step_ms": 150.0, "steps": 2}}
    assert metric("device_busy_ms.train", rec) == pytest.approx(22.5)
    assert metric("idle_pct.train", rec) == pytest.approx(77.5)
    assert metric("profiled_step_ms.train", rec) == pytest.approx(150.0)


def test_vgg16_count_at_224():
    """VGG16's convolutions: ~15.5 GMACs published (15.35 of them the
    thirteen convolutions, the rest the classifier)."""
    assert vgg16.conv_macs(224, 224) == pytest.approx(15.35e9, rel=2e-3)
    assert vgg16.lpips_step_flops(16, 512, 512) == pytest.approx(7.70e12,
                                                                 rel=1e-3)


def test_timenet_and_compositor_counts():
    assert timenet.input_dim(32) == 104
    # 104*256 + 7*256*256 + 360*256 (the skip) ... counted by hand:
    macs = (104 * 256 + 256 * 256 * 4 + (256 + 104) * 256 + 256 * 256 * 2
            + 2 * 256 * 256 + 256 * 7)
    assert timenet.flops_per_point(32) == 2.0 * macs
    ops, nbytes = compositor.k1(1000, 100, 10, 5, 2, 32, 128, 7)
    assert ops == 1000 * 16 + 100 * (21 - 16 + 14)
    assert nbytes == 5 * 64 + 40 + 8 + 8 * 32 * 128 * 4
