"""LPIPS's calls a step, a motion's renders each: the chunks that the
program's recorder counted in the window's steps (`lpips_chunks` of
`step_totals`). None where the program counts no chunks, as a program
that runs LPIPS over the whole batch does not."""
from harness.spans import step_mean


def read(rec):
    try:
        n = step_mean(rec, "lpips_chunks")
    except KeyError:            # a recorder without the counter
        return None
    return n or None
