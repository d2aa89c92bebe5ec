"""The benchmark's own tests: on the CPU at tiny sizes (the plain
versions of the program's kernels), and marked `card` where they need
the card. Run from the root of the repo:

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec as spec_mod  # noqa: E402

TINY = {
    "dimo-s2": {"num_cpts": 32, "latent_code_dim": 8, "num_views": 3,
                "num_frames": 5, "ref_size": 64, "batch_size": 1,
                "start_step": 100, "settled_tile_capacity": 256,
                "tile_capacity": 256, "W": 96, "H": 96,
                "scene": {"num_gaussians": 2048, "num_motions": 3,
                          "log_scale_shift": 0.6}},
    "dimo-s1": {"num_cpts": 32, "latent_code_dim": 8, "num_views": 3,
                "num_frames": 5, "ref_size": 64, "batch_size": 1,
                "start_step": 100, "settled_tile_capacity": 256,
                "tile_capacity": 256,
                "scene": {"num_gaussians": 1024, "num_motions": 3,
                          "log_scale_shift": 1.5}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips "
                            "without one")


# built and checked, not in BENCHMARK.json yet (PERF.md, Open questions)
PENDING = {"s2-serve-seq800": {"name": "s2-serve-seq800", "config": "dimo-s2",
                               "traffic": "seq800", "chips": 1}}


def tiny_cell(name: str, limits: dict | None = None) -> dict:
    """Cell `name` of BENCHMARK.json (or PENDING) at a size the CPU runs in
    seconds."""
    spec = spec_mod.load_spec(ROOT)
    cell = (spec_mod.cell_of(spec, PENDING[name], ROOT) if name in PENDING
            else spec_mod.cell(spec, name, ROOT))
    cell = copy.deepcopy(cell)
    cfg = cell["config"]
    cfg.update(copy.deepcopy(TINY[cell["workload"]["config"]]))
    cell["traffic"]["checked_frames"] = 3
    if limits is not None:
        cell["limits"] = limits
    return cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
