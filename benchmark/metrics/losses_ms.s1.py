"""`losses_ms.train`'s reading, in the cells where `train_step_ms` is reported
per layer (`train_step_ms.s1`)."""
from harness.spec import load_module

read = load_module("metrics", "losses_ms.train").read
