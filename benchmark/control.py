"""The readings that the limits of `correct` are set from, at a cell's
own size on the card (the benchmark's own runs do not run this):

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--variants program,control,...]

For each seed, one line of JSON: each variant's numbers against the
float32 reference. "program" is the program's sound run; "control" the
reference computed with TF32 on in the program's place (the nearest
precision below the configuration's float32); the other variants are
faults planted in the reference put in the program's place (training:
"half_batch", half of each batch left out and the means taken over the
rest; serving: "next_frame", each frame's successor delivered in its
place). A state left unchanged reads 1 by the training numbers' measure
and needs no run. The last line gives each variant's largest and
smallest reading of each number over the seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from harness import spec as spec_mod  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec_mod.cell(spec_mod.load_spec(ROOT), a.workload, ROOT)
    driver = spec_mod.load_module("drivers", cell["traffic"]["driver"])
    kw = {"variants": tuple(a.variants.split(","))} if a.variants else {}
    save = os.path.join(ROOT, "build", "bench", a.workload)
    summary = {}
    for seed in (int(x) for x in a.seeds.split(",")):
        out = driver.readings(cell, seed, "cuda", save, **kw)
        print(json.dumps({"seed": seed, **out}), flush=True)
        for v, nums in out.items():
            if not isinstance(nums, dict) or v == "losses":
                continue
            for k, x in nums.items():
                lo, hi = summary.setdefault(v, {}).get(k, (x, x))
                summary[v][k] = (min(lo, x), max(hi, x))
    print(json.dumps({"min_max": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
