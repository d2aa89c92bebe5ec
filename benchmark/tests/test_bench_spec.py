"""The loader finds configurations, cells, traffic, limits and metric
readers by name, and refuses a name or a unit outside the allowed
characters."""
from __future__ import annotations

import json
import os
import shutil

import pytest

from conftest import BENCH, ROOT
from harness import spec as spec_mod


def test_every_cell_finds_its_files():
    spec = spec_mod.load_spec(ROOT)
    for w in spec["workloads"]:
        cell = spec_mod.cell(spec, w["name"], ROOT)
        assert cell["config"]["source"]
        spec_mod.load_module("drivers", cell["traffic"]["driver"])
        assert cell["limits"]
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(spec_mod.load_module("metrics", m["name"]).read)


def test_contract_shape():
    spec = spec_mod.load_spec(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = [w["name"] for w in spec["workloads"]]
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in spec["configs"]:
        assert c["file"].startswith(spec["paths"][0] + "/")


@pytest.mark.parametrize("name", ["s2 train", "a,b", "x/y", "", "é",
                                  "-lead", "a" * 65])
def test_bad_names_are_refused(name):
    with pytest.raises(spec_mod.SpecError):
        spec_mod.check_name(name)


@pytest.mark.parametrize("unit", ["tokens per second", "", "µs",
                                  "a" * 17])
def test_bad_units_are_refused(unit):
    with pytest.raises(spec_mod.SpecError):
        spec_mod.check_unit(unit)


def test_a_refused_unit_stops_the_load(tmp_path):
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    spec["end_to_end"][1]["unit"] = "ms per step"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(spec_mod.SpecError):
        spec_mod.load_spec(str(tmp_path))


def test_unknown_cell_and_metric(tmp_path):
    spec = spec_mod.load_spec(ROOT)
    with pytest.raises(spec_mod.SpecError):
        spec_mod.cell(spec, "no-such-cell", ROOT)
    with pytest.raises(spec_mod.SpecError):
        spec_mod.load_module("metrics", "no_such_metric")


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    """A reader added as a file is found by the name BENCHMARK.json gives
    it, without an edit elsewhere; one that finds nothing is left out."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("tests"))
    (root / "metrics" / "steps.train.py").write_text(
        "def read(rec):\n    t = rec.get('train')\n"
        "    return None if not t else t['steps']\n")
    monkeypatch.setattr(spec_mod, "BENCH_DIR", str(root))
    entries = [{"name": "steps.train", "unit": "1"},
               {"name": "frames_per_s", "unit": "frames/s"}]
    out = spec_mod.read_metrics(entries, {"train": {"steps": 7}})
    assert out == {"steps.train": {"value": 7, "unit": "1"}}
