"""Device milliseconds of the step's `adam` segment (the step's own
`mark` split, CUDA events), mean over the window's steps."""


def read(rec):
    t = rec.get("train")
    segs = [s["adam"] for s in (t or {}).get("segments", []) if "adam" in s]
    return 1000.0 * sum(segs) / len(segs) if segs else None
