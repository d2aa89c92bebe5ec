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
event, on the device's clock) the stream had not yet reached. Each
activity is filed the same way under the segment it ran in, and the
breakdown names the kernels that took most time by segment, under names
cut to what tells one kernel from another.
"""
from __future__ import annotations

import contextlib
import re
import time
import zlib

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


def segment_of(marks: list, a: float, b: float, tail: str) -> str:
    """The segment in which the activity [a, b] ran: the first mark that
    the stream reached after its middle. On one stream no mark falls
    inside an activity, and a mark that closes a segment ends with the
    activity before it (the two clocks tie there), so the middle and not
    the end is read."""
    return name_gap(marks, 0.5 * (a + b), tail)


def by_segment(device: list, window: tuple, marks: list, tail: str) -> dict:
    """{segment: {"busy_s": the union of its activities in the window,
    "kernels": {full name: seconds}}}."""
    groups = {}
    for d in device:
        groups.setdefault(segment_of(marks, d[0], d[1], tail), []).append(d)
    out = {}
    for seg, acts in groups.items():
        names = by_name(acts, window)
        if names:
            out[seg] = {"busy_s": busy(acts, window)[0] * 1e-6,
                        "kernels": {k: v * 1e-6 for k, v in names.items()}}
    return out


NAME_LIMIT = 64
BUILTIN = {"bool", "char", "signed", "unsigned", "short", "int", "long",
           "float", "double", "void", "const", "volatile", "size_t",
           "int8_t", "uint8_t", "int16_t", "uint16_t", "int32_t", "uint32_t",
           "int64_t", "uint64_t", "true", "false"}


def _plain(arg: str) -> bool:
    """A template argument that is only a number or built-in types."""
    words = re.findall(r"[A-Za-z_]\w*|\d\w*", arg)
    return "<" not in arg and all(w in BUILTIN or w[0].isdigit()
                                  for w in words)


def _tree(text: str) -> tuple:
    """(name, [argument trees]) of `name<a, b<c>, ...>`, without the
    arguments that are only numbers or built-in types."""
    i = text.find("<")
    if i < 0 or not text.endswith(">"):
        return text.strip(), []
    args, depth, start = [], 0, i + 1
    for j in range(i + 1, len(text) - 1):
        depth += (text[j] == "<") - (text[j] == ">")
        if text[j] == "," and depth == 0:
            args.append(text[start:j])
            start = j + 1
    args.append(text[start:-1])
    return text[:i].strip(), [_tree(a.strip()) for a in args
                              if not _plain(a)]


def _render(node: tuple) -> str:
    name, kids = node
    return name + ("<" + ",".join(_render(k) for k in kids) + ">"
                   if kids else "")


def _leaves(node: tuple) -> list:
    return [node[0]] if not node[1] else [x for k in node[1]
                                          for x in _leaves(k)]


def short_name(full: str, limit: int = NAME_LIMIT, tag: bool = False) -> str:
    """A device activity's name without `void`, parameter lists, casts,
    lambdas, namespace qualifiers and the template arguments that are
    only numbers or built-in types. Over `limit` characters: the kernel
    and the innermost names of its arguments (its operation), then the
    kernel and the first of them, then that without the kernel's suffix
    `_kernel`, then the first characters of that. Those last, and every
    name with `tag`, end in a hash of the whole name (5 characters)."""
    s = re.sub(r"^\s*void\s+", "", full).replace("->", " to ")
    s = s.replace("(anonymous namespace)", "")
    for pat in (r"(?:(?<=[\w>)\]<,])|(?<=[<,]\s))\([^()]*\)",
                r"\{[^{}]*\}"):                      # innermost first
        while re.search(pat, s):
            s = re.sub(pat, "", s)
    s = re.sub(r"\b(?:operator|const)\b", "", s)
    s = re.sub(r"(?:\s*::\s*)+", "::", s)
    s = re.sub(r"(^|(?<=[<,\s]))::|::(?=\s*(?:[,>]|$))", "", s)
    s = re.sub(r"[A-Za-z_]\w*::", "", s)
    root, kids = _tree(s.strip())
    inner = list(dict.fromkeys(x for k in kids for x in _leaves(k)))
    first = f"<{inner[0]}>" if inner else ""
    names = [re.sub(r"[^\w<>,.\-]+", "_", n).strip("_") for n in (
        _render((root, kids)), f"{root}<{','.join(inner)}>", root + first,
        re.sub(r"_kernel$", "", root) + first)]
    room = limit - 5 if tag else limit
    name = next((n for n in names if len(n) <= room), None)
    if name is None:
        name, tag = names[-1][:limit - 5], True
    return name + ("-%04x" % (zlib.crc32(full.encode()) & 0xFFFF)
                   if tag else "")


def op_names(pairs: list) -> list:
    """`<segment>:<short name>` of each (segment, full name) pair: at most
    NAME_LIMIT characters, one kernel's name the same in every segment,
    distinct where the pairs are (kernels whose short names coincide get
    a hash)."""
    limit = NAME_LIMIT - 1 - max((len(seg) for seg, _ in pairs), default=0)
    short = {full: short_name(full, limit) for _, full in pairs}
    twins = {n for n in short.values()
             if sum(m == n for m in short.values()) > 1}
    short = {f: short_name(f, limit, tag=True) if n in twins else n
             for f, n in short.items()}
    return [f"{seg}:{short[full]}" for seg, full in pairs]


def summary(st: Stretch) -> dict | None:
    """busy_s, window_s, host_s, by_name (seconds), by_segment (each
    activity under the segment it ran in), and the breakdown: the ten
    (segment, kernel) pairs that took most device time and the ten
    longest idle gaps named by the host's segment."""
    if st.prof is None:
        return None
    dev = device_spans(st.prof)
    window = bounds(sorted((a, b) for a, b, name in dev if MARKER in name))
    dev = [d for d in dev if MARKER not in d[2]]
    marks = [(window[0] + 1e3 * st.start.elapsed_time(ev), label)
             for label, ev in st.marks]
    b, gaps = busy(dev, window)
    names = by_name(dev, window)
    segs = by_segment(dev, window, marks, st.tail)
    top = sorted(((seg, k, v) for seg, x in segs.items()
                  for k, v in x["kernels"].items()), key=lambda t: -t[2])[:10]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": b * 1e-6,
        "window_s": (window[1] - window[0]) * 1e-6,
        "host_s": st.host_s,
        "by_name": {k: v * 1e-6 for k, v in names.items()},
        "by_segment": segs,
        "breakdown": {
            "device_ops": [[n, v] for n, (_, _, v) in zip(
                op_names([(seg, k) for seg, k, _ in top]), top)],
            "idle_gaps": [[name_gap(marks, a, st.tail), (b2 - a) * 1e-6]
                          for a, b2 in longest]},
    }


def kernel_seconds(by_name: dict, patterns: tuple) -> float:
    """Seconds of the device activities whose name holds one of
    `patterns`."""
    return sum(v for k, v in by_name.items()
               if any(p in k for p in patterns))
