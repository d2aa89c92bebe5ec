"""Share of a step in which nothing ran on the device (%): the device's
busy time a step, from the profiled stretch, against the window's time
a step. Device time a step does not depend on the host's pace, while
the profiled stretch's own length does: the profiler's cost on every
launch makes its steps slower than the window's."""


def read(rec):
    t, w = rec.get("trace"), rec.get("train")
    if not w or not w.get("steps") or not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["steps"]
                    / (w["window_s"] / w["steps"]))
