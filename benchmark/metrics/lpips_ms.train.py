"""Device milliseconds of the step's `lpips` segment (the step's own
`mark` split, CUDA events), mean over the window's steps."""


def read(rec):
    t = rec.get("train")
    segs = [s["lpips"] for s in (t or {}).get("segments", []) if "lpips" in s]
    return 1000.0 * sum(segs) / len(segs) if segs else None
