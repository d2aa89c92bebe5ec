"""Host milliseconds a step of the window inside the program's `host_read`
spans: the host's waits on the card."""
from harness.spans import step_mean


def read(rec):
    return step_mean(rec, "host_read_ms")
