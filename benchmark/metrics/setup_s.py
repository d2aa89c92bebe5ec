"""Seconds from process start to the first timed step or frame: imports,
kernel libraries (built once, then from the checkout's cache), inputs,
the Trainer, the first steps or the warm-up sequences (host clock)."""


def read(rec):
    return rec["setup_s"]
