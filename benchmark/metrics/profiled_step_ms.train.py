"""Time a step of the profiled stretch on the host's clock (ms): beside
`train_step_ms` it shows whether the stretch that `idle_pct.train` and
the rooflines read kept the window's pace."""


def read(rec):
    t = rec.get("trace")
    if rec.get("train") is None or not t or "step_ms" not in t:
        return None
    return t["step_ms"]
