"""Reading a device trace of a stretch of the run: what ran on the
device, for how long, and where it sat idle.

The stretch is traced with the profiler's device activity alone. No host
operator is recorded, so its steps keep the pace of the measured window
(recording every host operator made a train step 1.4-2x as long, and the
idle share then measured the profiler). Two pairs of short spin kernels
bound the stretch on the device. The busy time is the union of the device
activities' spans clipped to the stretch (the arithmetic of the
program's `utils/diagnostics.py::device_busy_share`, copied); the idle
gaps are the holes in that union. A gap is named by what the host was
doing when it opened: the segment of the run whose closing mark (a CUDA
event, on the device's clock) the stream had not yet reached.
"""
from __future__ import annotations

import contextlib
import time

import torch

MARKER = "spin_kernel"      # the kernel of torch.cuda._sleep
SPIN_CYCLES = 200_000       # about 0.1 ms a spin, two spins a bound


class Stretch:
    """A stretch to trace. While `profile()` runs, `note(label, event)`
    keeps a CUDA event as the close of the segment `label`; the segment
    after the last note is `tail`."""

    def __init__(self, clock, tail: str):
        self.clock, self.tail = clock, tail
        self.marks, self.active = [], False
        self.prof = self.start = None
        self.host_s = 0.0

    def note(self, label: str, event=None) -> None:
        if self.active:
            self.marks.append((label, event if event is not None
                               else self.clock.mark()))

    @contextlib.contextmanager
    def profile(self):
        """Trace the block's device activity between spin kernels;
        `host_s` is its length on the host's clock. Without a card
        nothing is traced."""
        if not self.clock.cuda:
            yield self
            return
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            spin()
            self.start = self.clock.mark()      # completes as the spins end
            t0 = time.perf_counter()
            self.active = True
            try:
                yield self
            finally:
                self.active = False
                spin()
                torch.cuda.synchronize()
                self.host_s = time.perf_counter() - t0
        self.prof = prof


def spin() -> None:
    """Two spin kernels back to back: a bound that one activity record
    lost from the trace does not move."""
    for _ in range(2):
        torch.cuda._sleep(SPIN_CYCLES)


def bounds(spins: list) -> tuple:
    """(end of the opening spins, start of the closing spins) of the
    [(start, end)] spins, in order: the opening pair lies within a
    millisecond of the first spin's start."""
    first = [b for a, b in spins if a < spins[0][0] + 1e3]
    last = [a for a, b in spins if a >= spins[0][0] + 1e3]
    if not last:
        raise ValueError(f"no closing {MARKER} in the trace")
    return max(first), min(last)


def device_spans(prof) -> list:
    """[(start, end, name)] of the device activities, microseconds."""
    return [(float(e.time_range.start), float(e.time_range.end), e.name)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy(device: list, window: tuple) -> tuple:
    """(busy microseconds, [(gap start, gap end)]) of the device spans
    clipped to `window`."""
    w0, w1 = window
    clipped = sorted((max(a, w0), min(b, w1)) for a, b, _ in device)
    total, end, gaps = 0.0, w0, []
    for a, b in clipped:
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
            total += b - a
        elif b > end:
            total += b - end
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    return total, gaps


def by_name(device: list, window: tuple) -> dict:
    """{device activity name: microseconds inside the window}."""
    w0, w1 = window
    out = {}
    for a, b, name in device:
        d = min(b, w1) - max(a, w0)
        if d > 0:
            out[name] = out.get(name, 0.0) + d
    return out


def name_gap(marks: list, t: float, tail: str) -> str:
    """The segment the host was in at time t: the label of the first mark
    [(time, label)] (in stream order) that the device reached after t.
    The stream is empty in a gap, so a mark recorded before t was
    reached by t, and one reached after t was recorded after it."""
    return next((label for at, label in marks if at > t), tail)


def summary(st: Stretch) -> dict | None:
    """busy_s, window_s, host_s, by_name (seconds), and the breakdown: the
    ten device activities that took most time and the ten longest idle
    gaps named by the host's segment."""
    if st.prof is None:
        return None
    dev = device_spans(st.prof)
    window = bounds(sorted((a, b) for a, b, name in dev if MARKER in name))
    dev = [d for d in dev if MARKER not in d[2]]
    marks = [(window[0] + 1e3 * st.start.elapsed_time(ev), label)
             for label, ev in st.marks]
    b, gaps = busy(dev, window)
    names = by_name(dev, window)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": b * 1e-6,
        "window_s": (window[1] - window[0]) * 1e-6,
        "host_s": st.host_s,
        "by_name": {k: v * 1e-6 for k, v in names.items()},
        "breakdown": {
            "device_ops": [[k, v * 1e-6] for k, v in top],
            "idle_gaps": [[name_gap(marks, a, st.tail), (b2 - a) * 1e-6]
                          for a, b2 in longest]},
    }


def kernel_seconds(by_name: dict, patterns: tuple) -> float:
    """Seconds of the device activities whose name holds one of
    `patterns`."""
    return sum(v for k, v in by_name.items()
               if any(p in k for p in patterns))
