"""`mfu_pct.train`'s reading, in `s2b4-train-lpips`."""
from harness.spec import load_module

read = load_module("metrics", "mfu_pct.train").read
