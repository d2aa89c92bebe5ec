"""Training as `train_loop` drives it, `Trainer.train_step_once` in a
loop, for a batch whose reference step does not fit the card whole: the
reference follows the first steps a motion at a time
(`reference/step_blocks.py`). LPIPS's work in the profiled steps is
counted whole, its forward through both towers and the rendered tower's
input gradient (`work/vgg16.py::lpips_step_flops`), since the program
runs all of it in the step's `lpips` segment, a motion at a time.
"""
from __future__ import annotations

from harness import spec as spec_mod
from reference import step_blocks
from work import vgg16

# this driver's own copy of `train_loop`, whose reference step is the
# blocked one; `train_loop` itself, which other cells run, is untouched
base = spec_mod.load_module("drivers", "train_loop")
base.ref_step = step_blocks
readings = base.readings


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        save_path: str, t_start: float) -> dict:
    out = base.run(cell, seed, seconds, trace, device, save_path, t_start)
    work = out["record"].get("work")
    if work and "lpips_flops" in work:
        opt = base.trainer_opt(cell["config"], seed, save_path)
        _, b, res = base.step_images(cell["config"], opt)
        work["lpips_flops"] = len(base.PROFILED) * vgg16.lpips_step_flops(
            b, res, res)
    return out
