"""The control comes out not correct: the reference computed with TF32
on, in the program's place, fails at least one of each cell's numbers
under the cell's limits, at the cell's own size. Needs the card (TF32 is
a property of its matmuls and convolutions); skips without one."""
from __future__ import annotations

import pytest

from conftest import ROOT
from harness import spec as spec_mod

CELLS = [w["name"] for w in spec_mod.load_spec(ROOT)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, card, tmp_path):
    cell = spec_mod.cell(spec_mod.load_spec(ROOT), name, ROOT)
    driver = spec_mod.load_module("drivers", cell["traffic"]["driver"])
    got = driver.readings(cell, 3300000001, card, str(tmp_path),
                          variants=("program", "control"))
    limits = cell["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items()), got
    assert any(got["control"][k] > v for k, v in limits.items()), got
