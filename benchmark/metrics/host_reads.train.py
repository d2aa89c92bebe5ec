"""Times a step of the window that the host waits for the card's queue to
drain: the `host_read` spans inside the program's `step` spans (reads of
device values, copies from pageable memory; by site in `step_totals`)."""
from harness.spans import step_mean


def read(rec):
    return step_mean(rec, "host_reads")
