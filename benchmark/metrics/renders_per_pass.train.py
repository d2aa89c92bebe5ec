"""Renders a render pass holds: the jobs over the passes that the
program's recorder counted in the window's steps (`render_jobs`,
`render_passes` of `step_totals`). None where the program counts no
passes, as a program that renders job by job does not."""
from harness.spans import step_mean


def read(rec):
    try:
        jobs = step_mean(rec, "render_jobs")
        passes = step_mean(rec, "render_passes")
    except KeyError:            # a recorder without the counters
        return None
    return jobs / passes if jobs is not None and passes else None
