"""`train_step_ms`'s reading in a cell whose host-paced step spreads too
widely between runs for an end-to-end bound: the traced run's window
over all the steps completed in it (host clock)."""
from harness.spec import load_module

read = load_module("metrics", "train_step_ms").read
