"""Device milliseconds of the step's `backward` segment (the step's own
`mark` split, CUDA events), mean over the window's steps."""


def read(rec):
    t = rec.get("train")
    segs = [s["backward"] for s in (t or {}).get("segments", []) if "backward" in s]
    return 1000.0 * sum(segs) / len(segs) if segs else None
