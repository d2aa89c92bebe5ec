"""The recorder of `dimo_tpu_torch/utils/diagnostics.py` over the port's
`Trainer`, on the CPU at `tiny_synthetic_opt`'s size with the dataset on
the host route (the packer): the span tree of a step, its blocking reads
counted by site, nothing recorded and no CUDA event made while it is
off, the same bits traced and untraced, and memory bounded."""
import contextlib
import tracemalloc

import numpy as np
import pytest
import torch

from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.presets import tiny_synthetic_opt
from dimo_tpu_torch.train.loop import Trainer
from dimo_tpu_torch.utils import diagnostics

from torch_parity import one_torch_thread  # noqa: F401

SEGMENTS = ["renders", "lpips", "losses", "backward", "adam"]


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder, off, for each test (a marked step turns the
    process's own on for good)."""
    rec = diagnostics.Recorder()
    monkeypatch.setattr(diagnostics, "RECORDER", rec)
    monkeypatch.setenv("DIMO_DEVICE_DATA", "0")
    return rec


@pytest.fixture(scope="module")
def data():
    return make_synthetic_videos(num_motions=2, num_views=3, num_frames=5,
                                 ref_size=64, seed=0, device="cpu")


def lpips_fn(a, b):
    return torch.mean((a - b) ** 2, dim=(1, 2, 3))


def trainer(data, stage: str, tmp_path, **kw):
    """A Trainer ready for `stage`'s steps (s2: after one s1 step and
    `finish_s1`)."""
    opt = tiny_synthetic_opt(save_path=str(tmp_path), **kw)
    tr = Trainer(opt, *data, device="cpu")
    tr.prepare_train_s1()
    if stage == "s2":
        tr.train_step_once(lpips_fn)
        tr.finish_s1()
        tr.prepare_train_s2()
    return tr


def check_tree(spans):
    """Every span closed and inside its parent; the step's segments in
    order under it; `packer_wait` under `sample_batch`."""
    root = spans[0]
    assert root.name == "step" and root.parent is None
    for s in spans:
        assert s.t1 is not None and s.t0 <= s.t1, s.name
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1, s.name
            assert s.step == root.step
    under = [s.name for s in spans if s.parent is root]
    assert [n for n in under if n in SEGMENTS] == SEGMENTS
    assert under[0] == "sample_batch"
    waits = [s for s in spans if s.name == "packer_wait"]
    assert waits and all(s.parent.name == "sample_batch" for s in waits)
    assert all(s.parent.name != "host_read" for s in spans if s.parent)


def expected_sites(stage: str, renders: int, motions: int, step: int,
                   sampled: bool, t_samples: int = 8) -> dict:
    """{site: host_read spans} of one step on the CPU (a card adds the
    packer's `packer_slot` and, with the VGG LPIPS, two `lpips_norm`).
    The step's r renders are one pass (`render_batch`), whose sites count
    once however many jobs it holds."""
    r, m = renders, motions
    want = {"bin_n_med": 1, "bin_n_big": 1, "grad_guard": 1,
            "camera": 3, "timenet_time": 1,
            "posenc_freqs": 2 + 2 * m,           # the pass's and ARAP's TimeNet
            "ssim_window": m, "mse_w": 1, "arap_times": 1, "adam_betas": 2}
    # the kinks' bounds: projection's two clips and a maximum, the image's
    # clip (7 a pass); ARAP's neighbour distances, a time sample of each
    # motion (the shared graph) or a motion (sampled nodes); in s2 the
    # chamfer's distances a render and the KNN's
    arap = m if sampled else t_samples * m
    want["kink_bound"] = 7 + arap + (r + 1 if stage == "s2" else 0)
    if stage == "s1":
        want["mean2d_tap"] = 1
    if sampled:
        want["arap_sample"] = want["arap_upload"] = m
    if step % 10 == 0:
        want["overflow"] = 2
    return want


@pytest.mark.parametrize("stage,kw", [
    ("s1", {}), ("s2", {}),
    # over arap's 512 samples: the s1 ARAP draws its nodes on the host
    ("s1", {"capacity_s1": 1024, "num_cpts": 600})],
    ids=["s1", "s2", "s1-arap-sampled"])
def test_step_spans_and_reads_by_site(data, tmp_path, recorder, stage, kw):
    tr = trainer(data, stage, tmp_path, **kw)
    tr.step = 8                        # steps 9 and 10: overflow read at 10
    with diagnostics.tracing():
        for _ in range(2):
            tr.train_step_once(lpips_fn)
    steps = recorder.completed_steps(2)
    totals = diagnostics.step_totals(2)
    sampled = stage == "s1" and tr.state.params.xyz.shape[0] > 512
    for spans, tot, step in zip(steps, totals, (9, 10)):
        check_tree(spans)
        assert tot["step"] == step
        # 1 frame x 1 view x 2 motions
        want = expected_sites(stage, 2, 2, step, sampled)
        assert tot["sites"] == want
        assert tot["host_reads"] == sum(want.values())
        assert tot["host_busy_ms"] + tot["host_read_ms"] \
            + tot["packer_wait_ms"] == pytest.approx(tot["host_ms"])
        assert tot["packer_wait_ms"] > 0 and tot["device_ms"] == {}
        assert (tot["render_jobs"], tot["render_passes"]) == (2, 1)
        # each read sits where its code runs
        parents = {}
        for s in spans:
            if s.name == "host_read":
                parents.setdefault(s.site, set()).add(s.parent.name)
        assert parents["bin_n_med"] == parents["bin_n_big"] \
            == parents["camera"] == {"renders"}
        assert parents["kink_bound"] == {"renders", "losses"}   # ARAP's
        assert parents["grad_guard"] == {"step"}
        assert parents["adam_betas"] == {"adam"}
        if sampled:
            assert parents["arap_sample"] == {"losses"}


@pytest.mark.parametrize("batch_size,jobs", [(1, 2), (2, 8)])
def test_render_counters_read_the_jobs_of_the_steps_one_pass(
        data, tmp_path, recorder, batch_size, jobs):
    """`render_jobs` / `render_passes` of a step read r / 1 for the step's
    r = frames x views x motions jobs (batch_size b: b x b x 2 here); with
    nothing open the counters add nothing, and off they record nothing."""
    tr = trainer(data, "s2", tmp_path, batch_size=batch_size)
    tr.train_step_once(lpips_fn)
    assert recorder.completed_steps(1) is None
    with diagnostics.tracing():
        recorder.count("render_jobs", 5)          # no span open: dropped
        tr.train_step_once(lpips_fn)
    (tot,) = diagnostics.step_totals(1)
    assert (tot["render_jobs"], tot["render_passes"]) == (jobs, 1)
    with diagnostics.tracing(), diagnostics.span("step", step=0):
        pass
    (tot,) = diagnostics.step_totals(1)
    assert (tot["render_jobs"], tot["render_passes"]) == (0, 0)


def test_a_marked_step_turns_the_recorder_on_for_good(data, tmp_path,
                                                      recorder):
    """The benchmark's rule: a caller that passes `mark` traces the step;
    the marks come at the ends of the five segments, in order."""
    tr = trainer(data, "s2", tmp_path)
    assert not recorder.on
    get = tr.get_step_fn
    marks = []

    def marked(*a, **k):
        fn = get(*a, **k)
        return lambda state, batch: fn(state, batch, mark=marks.append)
    tr.get_step_fn = marked
    tr.train_step_once(lpips_fn)        # turned on inside the step
    assert recorder.on and recorder.started and marks == SEGMENTS
    assert recorder.completed_steps(1) is None
    for _ in range(2):
        tr.train_step_once(lpips_fn)
    with diagnostics.tracing():
        pass
    assert recorder.on
    for spans in recorder.completed_steps(2):
        check_tree(spans)


def test_off_records_nothing_and_makes_no_cuda_event(data, tmp_path,
                                                     recorder, monkeypatch):
    tr = trainer(data, "s1", tmp_path)

    def no_event(*a, **k):
        raise AssertionError("a CUDA event while the recorder is off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    for _ in range(2):
        tr.train_step_once(lpips_fn)
    assert not recorder.on and len(recorder._steps) == 0
    assert recorder.completed_steps(1) is None
    assert diagnostics.step_totals(1) is None
    # on, the same process would make them (the patch is live)
    with pytest.raises(AssertionError, match="CUDA event"):
        with diagnostics.tracing():
            tr.train_step_once(lpips_fn)


def test_off_sites_allocate_nothing(recorder):
    x = 7
    span, read, cut = diagnostics.span, diagnostics.host_read, recorder.cut

    def sites():
        for _ in range(1000):
            with span("sample_batch"):
                read("bin_n_med", x)
            cut("renders", None)
    sites()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        sites()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # 3,000 site calls: one object made a call would be over 48 kB (the
    # loop's own range and iterator are the rest)
    assert after == before and peak - before < 1000
    assert len(recorder._steps) == 0


def test_traced_and_untraced_steps_give_the_same_bits(data, tmp_path):
    prints = []
    for traced in (False, True):
        tr = trainer(data, "s2", tmp_path / str(traced))
        with (diagnostics.tracing() if traced else contextlib.nullcontext()):
            for _ in range(2):
                tr.train_step_once(lpips_fn)
        prints.append(diagnostics.run_fingerprint(tr))
        prints[-1]["files"] = {}        # the folders' names differ
    assert diagnostics.fingerprint_diff(*prints) == {}


def test_memory_stays_bounded_over_more_steps_than_the_bound(
        data, tmp_path, monkeypatch):
    small = diagnostics.Recorder(keep_steps=3)
    monkeypatch.setattr(diagnostics, "RECORDER", small)
    tr = trainer(data, "s1", tmp_path)
    with diagnostics.tracing():
        for _ in range(5):
            tr.train_step_once(lpips_fn)
        assert len(small._steps) == 3
        assert [g[0].step for g in small.completed_steps(3)] == [3, 4, 5]
        assert small.completed_steps(4) is None
        # one group a root span, however many
        for i in range(300):
            with diagnostics.span("step", step=i):
                diagnostics.host_read("x", 1)
        assert len(small._steps) == 3 and not small._stack
        assert [t["step"] for t in diagnostics.step_totals(3)] \
            == [297, 298, 299]


@pytest.mark.parametrize("value,dtype", [
    (3, torch.int32), (0, torch.int32), (-2, torch.int64),
    (2.5, torch.float32), (1e20, torch.float32), (1, torch.bool)])
@pytest.mark.parametrize("read", [int, float, bool])
def test_host_read_returns_what_the_read_returns(recorder, value, dtype,
                                                 read):
    x = torch.tensor(value, dtype=dtype)
    want = read(x)
    got_off = diagnostics.host_read("site", x, read)
    with diagnostics.tracing():
        got_on = diagnostics.host_read("site", x, read)
    for got in (got_off, got_on):
        assert type(got) is type(want) and got == want
    assert diagnostics.host_read("site", np.float32(2.5), float) == 2.5
    (group,) = recorder._steps
    assert [(s.name, s.site) for s in group] == [("host_read", "site")]
