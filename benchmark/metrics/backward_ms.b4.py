"""`backward_ms.train`'s reading, in `s2b4-train-lpips`."""
from harness.spec import load_module

read = load_module("metrics", "backward_ms.train").read
