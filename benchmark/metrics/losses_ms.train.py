"""Device milliseconds of the step's `losses` segment (the step's own
`mark` split, CUDA events), mean over the window's steps."""


def read(rec):
    t = rec.get("train")
    segs = [s["losses"] for s in (t or {}).get("segments", []) if "losses" in s]
    return 1000.0 * sum(segs) / len(segs) if segs else None
