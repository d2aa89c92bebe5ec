"""Device time a step (ms): the union of the device's activity over the
profiled stretch, a step. The host's pace does not move it."""


def read(rec):
    t = rec.get("trace")
    if rec.get("train") is None or not t or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / t["steps"]
