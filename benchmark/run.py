"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. With `--trace 0` the line holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics and the
device's busy time. The last lines on standard error, and the `checks`
key of the result, give each number that decided `correct` beside its
limit. Exits 1 without a result when there is no card, when the cell
asks for more cards than there are, or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "dimo_tpu")
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench_cache", _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [BENCH_DIR, ROOT]

import torch  # noqa: E402

from harness import spec as spec_mod  # noqa: E402


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.partition(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: str = ROOT, t_start: float | None = None) -> dict:
    """The outcome of one run of cell `name`: {"record",
    "correct", "checks", "attempted", "failed", "peak_bytes"}, with the
    metrics read from the record under "metrics"."""
    spec = spec_mod.load_spec(root)
    cell = spec_mod.cell(spec, name, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = spec_mod.load_module("drivers", cell["traffic"]["driver"])
    save_path = os.path.join(root, "build", "bench", name)
    out = driver.run(cell, seed, seconds, trace, device, save_path,
                     T_START if t_start is None else t_start)
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    out["metrics"] = spec_mod.read_metrics(entries, out["record"])
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = spec_mod.load_spec(ROOT)
    chips = next((w["chips"] for w in spec["workloads"]
                  if w["name"] == a.workload), None)
    if chips is None:
        print(f"no workload {a.workload!r}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"loaded modules that the benchmark forbids: {found}",
              file=sys.stderr)
        return 1
    rec = out["record"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["peak_bytes"],
              "power_limit": power_limit()}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if a.trace and rec.get("trace"):
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        line["breakdown"] = rec["trace"]["breakdown"]
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in out["checks"]}
    info = {k: rec[k] for k in ("setup_s", "reference_s", "capacity_moved",
                                "setup_step_ms") if k in rec}
    if rec.get("trace") and "step_ms" in rec["trace"]:
        info["traced_step_ms"] = rec["trace"]["step_ms"]
    info["numbers"] = out["numbers"]
    if rec.get("train"):
        info["train_step_s"] = rec["train"]["step_s"]
    for key, part in (("step_s", "train"), ("intervals", "serve")):
        v = sorted(rec.get(part, {}).get(key, []))
        if v:
            info[f"{part}_host_ms_quartiles"] = [
                1000.0 * v[int(q * (len(v) - 1))] for q in (0.25, 0.5, 0.75)]
    print(f"info {json.dumps(info)}", file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
