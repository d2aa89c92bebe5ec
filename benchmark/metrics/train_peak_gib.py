"""The device memory a train step needs: the peak allocated over the
window, counted from the window's start (GiB)."""


def read(rec):
    t = rec.get("train")
    if not t or t["peak_bytes"] is None:
        return None
    return t["peak_bytes"] / 2 ** 30
