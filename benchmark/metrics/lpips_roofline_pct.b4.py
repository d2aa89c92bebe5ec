"""`lpips_roofline_pct.train`'s reading, in `s2b4-train-lpips`, whose
driver counts LPIPS's whole work (both towers' forward and the rendered
tower's input gradient), all of which the program runs in the `lpips`
segment."""
from harness.spec import load_module

read = load_module("metrics", "lpips_roofline_pct.train").read
