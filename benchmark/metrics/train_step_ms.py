"""Milliseconds a train step: the whole window, ending in a synchronize,
over all the steps completed in it (host clock)."""


def read(rec):
    t = rec.get("train")
    return None if not t else 1000.0 * t["window_s"] / t["steps"]
