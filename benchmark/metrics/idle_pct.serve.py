"""Share of the profiled stretch (one sequence) in which nothing ran on the
device (%)."""


def read(rec):
    t = rec.get("trace")
    if rec.get("serve") is None or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
