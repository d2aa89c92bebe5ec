"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs` entry, whose
`file` holds it) and a traffic mix (`traffic/<traffic>.json`, which names
its driver, `drivers/<driver>.py`); its correctness limits are in
`workloads/<cell>.json`. Each metric is read by `metrics/<name>.py`,
whose `read(record)` returns a number or None. The names and units are
checked against the characters the benchmark allows before anything
runs.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class SpecError(ValueError):
    """A name, unit or file that the benchmark refuses."""


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise SpecError(f"refused name {name!r}: 1-64 of A-Z a-z 0-9 _ . -, "
                        "starting with a letter, a digit or _")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.fullmatch(unit):
        raise SpecError(f"refused unit {unit!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    """BENCHMARK.json with every name and unit checked."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    for c in spec["configs"]:
        check_name(c["name"])
        for k in c["reduced"]:
            check_name(k)
    for w in spec["workloads"]:
        for k in ("name", "config", "traffic"):
            check_name(w[k])
    for m in spec["end_to_end"] + spec["per_layer"]:
        check_name(m["name"])
        check_unit(m["unit"])
        for w in m.get("workloads", []):
            check_name(w)
    return spec


def cell(spec: dict, name: str, root: str = ROOT) -> dict:
    """Everything one cell runs with: its entry, configuration, traffic
    mix, limits and metrics ("end_to_end", "per_layer": the entries that
    apply to it)."""
    check_name(name)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise SpecError(f"no workload named {name!r} in BENCHMARK.json")
    return cell_of(spec, found[0], root)


def cell_of(spec: dict, w: dict, root: str = ROOT) -> dict:
    """`cell` for a workload entry `w` (one of `spec`'s, or one that a
    later PR will add)."""
    name = w["name"]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    applies = lambda m: name in m.get("workloads", [name])  # noqa: E731
    return {
        "workload": w,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(BENCH_DIR, "traffic",
                                          w["traffic"] + ".json")),
        "limits": load_json(os.path.join(BENCH_DIR, "workloads",
                                         name + ".json"))["limits"],
        "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
        "per_layer": [m for m in spec["per_layer"] if applies(m)],
    }


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` under the benchmark as a module (file names may
    hold dots, so they are loaded by path)."""
    check_name(name)
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.exists(path):
        raise SpecError(f"no {kind} file for {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(entries: list, record: dict) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something in `record`."""
    out = {}
    for m in entries:
        v = load_module("metrics", m["name"]).read(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
