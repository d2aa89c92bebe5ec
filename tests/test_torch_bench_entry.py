"""The port's measurement entry points on the CPU: `bench_torch.py`'s line
and scene hash against `bench.py`'s, `bench_train_torch.py`'s artifact
against `train_bench.json`'s keys, both refusing to run without a card,
and `dimo_tpu_torch/utils/diagnostics.py`.

No number here is a device measurement: the timings are of the CPU and
only checked for shape.
"""
import ast
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import bench_torch
import bench_train_torch
from dimo_tpu_torch.scenes import flagship_scene
from dimo_tpu_torch.utils import diagnostics

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_py_keys() -> set:
    """The keys of the line `bench.py` prints: its `json.dumps({...})` in
    `main`, with `**check` the keys of the dict `selfcheck` returns."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}

    def dict_keys(node):
        keys = set()
        for k, v in zip(node.keys, node.values):
            if k is None:
                keys |= returned[v.id]
            else:
                keys.add(k.value)
        return keys

    returned = {"check": set()}
    for node in ast.walk(funcs["selfcheck"]):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            returned["check"] = dict_keys(node.value)
    line = [n for n in ast.walk(funcs["main"]) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "dumps"]
    assert len(line) == 1
    return dict_keys(line[0].args[0])


def test_bench_line_has_bench_py_keys_and_device():
    want = _bench_py_keys()
    assert {"value", "cap_maxdiff_vs4096", "selfcheck_ok", "y_repeat"} <= want
    check = bench_torch.selfcheck("cpu")
    delta = dict.fromkeys(("cap_maxdiff_vs4096", "cap_badpx_gt_1_255",
                           "overflow_at_cap", "overflow_at_4096"), 0)
    line = bench_torch.result_line(100.0, 50.0, 120.0, delta, "shell-v2-x",
                                   check, "card, 700.00 W")
    assert set(line) == want | {"device"}
    assert line["y_repeat"] is None and line["fwd_inloop"] is None
    assert line["vs_baseline"] == 100.0 / bench_torch.REFERENCE_FPS_A100
    json.dumps(line)
    # the strip rasterizer agrees with the dense oracle here too
    assert check["selfcheck_ok"], check


def test_scene_hash_is_bench_py_s():
    from __graft_entry__ import _flagship_scene
    _, jp, _, _ = _flagship_scene()
    ref = hashlib.sha256(np.asarray(jp.xyz).tobytes()
                         + np.asarray(jp.scaling).tobytes()
                         + np.asarray(jp.opacity).tobytes()).hexdigest()[:12]
    _, tp, _, _ = flagship_scene(device="cpu")
    assert bench_torch.scene_hash(tp) == f"shell-v2-{ref}"


def test_bench_train_artifact_has_train_bench_json_keys():
    with open(os.path.join(REPO, "train_bench.json")) as f:
        want = set(json.load(f))
    args = bench_train_torch.parse_args(["--lpips", "--shape", "2,1,2"])
    art = bench_train_torch.artifact(args, 0.5, 3.0)
    assert set(art) == want
    assert art["backend"] == "cuda" and art["lpips"] is True
    assert art["batch"] == [2, 1, 2] and art["compile_s"] == 3.0
    assert art["it_per_s"] == 2.0
    assert art["host_batch_packer_ms"] is None


@pytest.mark.parametrize("main", [lambda: bench_torch.main(),
                                  lambda: bench_train_torch.main([])],
                         ids=["bench_torch", "bench_train_torch"])
def test_entry_points_refuse_to_run_without_a_card(monkeypatch, capsys, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main()
    assert capsys.readouterr().out == ""


def test_profile_trace(tmp_path):
    with diagnostics.profile_trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("window"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    path = tmp_path / diagnostics.TRACE_FILE
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "window" for e in events)
    busy = diagnostics.device_busy_share(str(path), "window")
    assert busy["kernels"] == 0 and busy["busy_share"] == 0.0
    assert busy["window_us"] > 0
    with pytest.raises(ValueError, match="nothing"):
        diagnostics.device_busy_share(str(path), "nothing")


def test_device_busy_share_unions_kernel_spans(tmp_path):
    ev = [{"name": "step", "ph": "X", "cat": "user_annotation", "ts": 100,
           "dur": 100},
          {"name": "step", "ph": "X", "cat": "gpu_user_annotation", "ts": 0,
           "dur": 1000},
          {"name": "a", "ph": "X", "cat": "kernel", "ts": 90, "dur": 20},
          {"name": "b", "ph": "X", "cat": "kernel", "ts": 105, "dur": 10},
          {"name": "a", "ph": "X", "cat": "kernel", "ts": 150, "dur": 10},
          {"name": "c", "ph": "X", "cat": "kernel", "ts": 195, "dur": 50},
          {"name": "d", "ph": "X", "cat": "kernel", "ts": 300, "dur": 5},
          {"name": "m", "ph": "X", "cat": "gpu_memcpy", "ts": 120, "dur": 20}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    busy = diagnostics.device_busy_share(str(path), "step")
    # [100, 115] + [150, 160] + [195, 200] inside [100, 200]
    assert busy["window_us"] == 100 and busy["busy_us"] == 30
    assert busy["busy_share"] == 0.3 and busy["kernels"] == 4
    assert busy["by_name"] == [("a", 20.0), ("b", 10.0), ("c", 5.0)]


def test_nan_checks_toggle_anomaly_mode():
    try:
        diagnostics.enable_nan_checks()
        assert torch.is_anomaly_enabled()
    finally:
        diagnostics.disable_nan_checks()
    assert not torch.is_anomaly_enabled()
