"""Host milliseconds a step of the window inside the program's
`packer_wait` spans: `BatchPacker.get`'s wait for the packer's worker
(layer: host batches)."""
from harness.spans import step_mean


def read(rec):
    return step_mean(rec, "packer_wait_ms")
