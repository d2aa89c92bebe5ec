"""Frames delivered to the host over the whole window, per second."""


def read(rec):
    s = rec.get("serve")
    return None if not s else s["frames"] / s["window_s"]
