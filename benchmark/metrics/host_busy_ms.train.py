"""Host milliseconds a step of the window of the host's own work: the
program's `step` span less its `host_read` and `packer_wait` spans (the
step's self time: launches, Python, the batch's draw)."""
from harness.spans import step_mean


def read(rec):
    return step_mean(rec, "host_busy_ms")
