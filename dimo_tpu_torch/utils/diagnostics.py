"""Observability hooks: spans of the train step, profiler traces, NaN
checks.

Counterpart of `dimo_tpu/utils/diagnostics.py`. The recorder (`RECORDER`,
`span`, `host_read`, `host_wait`, `tracing`, `step_totals`) splits the
host's time inside the program. `span(name)` records a named interval
with the Trainer step it belongs to, its parent (the innermost open
span), its host start and end (`time.perf_counter`) and, once the
process has used a card, a CUDA event at each end on the current stream:
the device clock that CUDA-event marks and a profiler's trace share.
`count(name, n)` adds to a counter of the open step (the render passes
and the jobs they hold, the LPIPS chunks and their images). Each place
where the host waits for the card's queue to drain is a span named
`host_read` with its `site`: a read of a device value,
`host_read(site, x)`, which returns what the read returns, or a block,
`host_wait(site)`, such as a copy from pageable host memory to the card,
which the runtime ends in a stream synchronize. The spans of the last
`KEEP_STEPS` steps stay in memory; their CUDA events are resolved only
when `step_totals` is read, after the caller's own synchronize (the
recorder never synchronizes).

The recorder is on inside `tracing()`, and from the first train step
called with a `mark` (`train/step.py::make_train_step`) for the rest of
the process: a caller that marks the step's segments is tracing it. Off,
each site costs one attribute check: no CUDA call, no allocation.

`profile_trace` is a `torch.profiler` trace (CPU and, where there is a
card, CUDA activity) written as a Chrome trace, and the NaN checks are
autograd's anomaly mode. `device_busy_share` reads such a trace: the share
of a window that the card spent in kernels. `run_fingerprint` /
`fingerprint_diff` hold two training runs to the reference's promise of a
deterministic program: the same seed and data leave the same bits.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import torch


KEEP_STEPS = 256          # groups (steps) whose spans stay in memory


class Span:
    """One recorded interval. `t0`, `t1`: host seconds; `e0`, `e1`: CUDA
    events at its ends, or None without a card; `counts`: on a group's
    first span, the group's counters ({name: n}, or None)."""
    __slots__ = ("name", "site", "step", "parent", "t0", "t1", "e0", "e1",
                 "counts")

    def __init__(self, name, site, step, parent, t0, e0):
        self.name, self.site, self.step, self.parent = name, site, step, parent
        self.t0, self.t1, self.e0, self.e1 = t0, None, e0, None
        self.counts = None

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.t1 - self.t0)

    def device_ms(self) -> float | None:
        """Milliseconds between its events on the card (after a
        synchronize), or None without them."""
        if self.e0 is None or self.e1 is None:
            return None
        return self.e0.elapsed_time(self.e1)


class _Open:
    """The context of one recorded span."""
    __slots__ = ("rec", "name", "site", "step", "span", "was")

    def __init__(self, rec, name, site, step):
        self.rec, self.name, self.site, self.step = rec, name, site, step

    def __enter__(self):
        self.was = self.rec.step
        if self.step is not None:
            self.rec.step = self.step
        self.span = self.rec.open(self.name, self.site)
        return self.span

    def __exit__(self, *exc):
        self.rec.close(self.span)
        self.rec.step = self.was
        return False


_OFF = contextlib.nullcontext()


class Recorder:
    """Spans of the program, kept for the last `keep_steps` Trainer steps
    (see the module docstring)."""

    def __init__(self, keep_steps: int = KEEP_STEPS):
        self.on = False
        self.started = False       # on for the rest of the process
        self.step = None           # the Trainer step of the spans opened now
        self._stack = []           # open spans, innermost last
        self._segment = None       # the open segment of `cut`
        # [[Span]] per group, a step's first: the `step` span
        self._steps = collections.deque(maxlen=keep_steps)

    def start(self) -> None:
        """On for the rest of the process."""
        self.on = self.started = True

    def open(self, name: str | None, site: str | None = None) -> Span:
        """Starts a span inside the innermost open one; a span opened
        with none open starts a new group, the spans of one step."""
        e0 = None
        if torch.cuda.is_initialized():
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        parent = self._stack[-1] if self._stack else None
        s = Span(name, site, self.step, parent, time.perf_counter(), e0)
        if parent is None:
            self._steps.append([])
        self._steps[-1].append(s)
        self._stack.append(s)
        return s

    def close(self, s: Span, name: str | None = None) -> None:
        """Ends `s`, and drops from the open spans any left open inside
        it; `name` names a span opened without one."""
        if s.e0 is not None:
            s.e1 = torch.cuda.Event(enable_timing=True)
            s.e1.record()
        s.t1 = time.perf_counter()
        if name is not None:
            s.name = name
        if s in self._stack:
            del self._stack[self._stack.index(s):]

    def span(self, name: str, step: int | None = None,
             site: str | None = None):
        """A context that records the block as span `name` (of `site`);
        `step` is the Trainer step of the spans opened inside it."""
        return _Open(self, name, site, step) if self.on else _OFF

    def host_read(self, site: str, x, read=int):
        """`read(x)` (e.g. `int(x)` of a CUDA tensor), recorded as a
        `host_read` span of `site`."""
        if not self.on:
            return read(x)
        s = self.open("host_read", site)
        try:
            return read(x)
        finally:
            self.close(s)

    def count(self, name: str, n: int = 1) -> None:
        """Adds n to counter `name` of the group of the open spans (the
        step's); nothing when off or with no span open."""
        if self.on and self._stack:
            root = self._stack[0]
            if root.counts is None:
                root.counts = {}
            root.counts[name] = root.counts.get(name, 0) + n

    def cut(self, name: str | None, mark=None, last: bool = False) -> None:
        """Ends the open segment of the train step as span `name` and,
        unless `last`, opens the next one; then calls `mark(name)`.
        `cut(None)` opens the step's first segment."""
        if self.on and (name is None or self._segment is not None):
            if name is not None:
                self.close(self._segment, name)
            self._segment = None if last else self.open(None)
        if mark is not None and name is not None:
            mark(name)

    def completed_steps(self, n: int) -> list | None:
        """[[spans of one step, its `step` span first]] of the last `n`
        steps whose `step` span has closed, oldest first; None when fewer
        are kept."""
        out = []
        for spans in reversed(self._steps):
            if spans[0].name == "step" and spans[0].t1 is not None:
                out.append(list(spans))
                if len(out) == n:
                    return out[::-1]
        return None


RECORDER = Recorder()


def span(name: str, step: int | None = None):
    """`RECORDER.span`: records the block as span `name` when on."""
    return RECORDER.span(name, step)


def host_read(site: str, x, read=int):
    """`read(x)` where the host waits for the card
    (`RECORDER.host_read`)."""
    return RECORDER.host_read(site, x, read)


def host_wait(site: str, when: bool = True):
    """A context for a block in which the host waits for the card's queue
    to drain, e.g. a copy from pageable host memory to the card, which
    the runtime ends in a stream synchronize: a `host_read` span of
    `site` (none where `when` is false)."""
    return RECORDER.span("host_read", site=site) if when else _OFF


@contextlib.contextmanager
def tracing():
    """The recorder on for the block (after it, as it was, or on if a
    marked step started it)."""
    was, RECORDER.on = RECORDER.on, True
    try:
        yield
    finally:
        RECORDER.on = was or RECORDER.started


def step_totals(n: int) -> list | None:
    """Per step, for the last `n` completed steps, oldest first: {"step",
    "host_ms" (the `step` span), "host_reads", "host_read_ms",
    "packer_wait_ms", "host_busy_ms" (the step's time outside both),
    "sites" ({site: reads}), "device_ms" ({span name: device ms of the
    step's spans of that name, summed}, with a card), "render_jobs" and
    "render_passes" (the jobs rendered and the passes that held them),
    "lpips_chunks" and "lpips_chunk_images" (LPIPS's calls, whole
    motions each, and the images they held), "lpips_convs" and
    "lpips_epilogues" (VGG convolutions run, and fused epilogues
    launched)}; None when fewer steps are kept."""
    steps = RECORDER.completed_steps(n) if n else None
    if steps is None:
        return None
    out = []
    for spans in steps:
        root = spans[0]
        reads = [s for s in spans if s.name == "host_read"
                 and s.t1 is not None]
        wait = sum(s.host_ms for s in spans
                   if s.name == "packer_wait" and s.t1 is not None)
        sites, dev = {}, {}
        for s in reads:
            sites[s.site] = sites.get(s.site, 0) + 1
        for s in spans:
            d = s.device_ms() if s.t1 is not None else None
            if d is not None:
                dev[s.name] = dev.get(s.name, 0.0) + d
        read_ms = sum(s.host_ms for s in reads)
        counts = root.counts or {}
        out.append({"step": root.step, "host_ms": root.host_ms,
                    "host_reads": len(reads), "host_read_ms": read_ms,
                    "packer_wait_ms": wait,
                    "host_busy_ms": root.host_ms - read_ms - wait,
                    "sites": sites, "device_ms": dev,
                    "render_jobs": counts.get("render_jobs", 0),
                    "render_passes": counts.get("render_passes", 0),
                    "lpips_chunks": counts.get("lpips_chunks", 0),
                    "lpips_chunk_images": counts.get("lpips_chunk_images",
                                                     0),
                    "lpips_convs": counts.get("lpips_convs", 0),
                    "lpips_epilogues": counts.get("lpips_epilogues", 0)})
    return out


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(logdir: str):
    """A `torch.profiler` trace of the block, CPU activity and, with a
    card, CUDA activity; written to `logdir/trace.json` (Chrome trace
    format: chrome://tracing, Perfetto) when the block exits. Yields the
    profiler, e.g. for `key_averages()`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def device_busy_share(trace_path: str, window: str) -> dict:
    """How busy the card was inside a window of a Chrome trace written by
    `profile_trace`: the window is the first event named `window` (e.g. a
    `torch.profiler.record_function` around a step that ends in a
    synchronize), the busy time is the union of the kernel events' spans
    clipped to it. Returns {"window_us", "busy_us", "busy_share",
    "kernels", "by_name": [(kernel name, clipped us summed), ...] most
    first}."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    win = next((e for e in events if e.get("name") == window
                and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"),
               None)
    if win is None:
        raise ValueError(f"no event named {window!r} in {trace_path}")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans = sorted((max(float(e["ts"]), w0),
                    min(float(e["ts"]) + float(e["dur"]), w1), e["name"])
                   for e in events
                   if e.get("cat") == "kernel" and e.get("ph") == "X")
    busy, end, n = 0.0, w0, 0
    by_name = {}
    for a, b, name in spans:
        if b <= a:
            continue
        n += 1
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if a > end:
            busy += b - a
        elif b > end:
            busy += b - end
        end = max(end, b)
    return {"window_us": w1 - w0, "busy_us": busy,
            "busy_share": busy / (w1 - w0) if w1 > w0 else 0.0,
            "kernels": n,
            "by_name": sorted(by_name.items(), key=lambda kv: -kv[1])}


def enable_nan_checks():
    """Autograd's anomaly mode: a backward that produces NaN raises, with
    the forward op that made it."""
    torch.autograd.set_detect_anomaly(True)


def disable_nan_checks():
    torch.autograd.set_detect_anomaly(False)


def run_fingerprint(trainer) -> dict:
    """What a `Trainer` run leaves, copied to the host: every parameter
    leaf and Adam moment, the Adam step, the active masks, the stage and
    step, and the bytes of every file under `opt.save_path`."""
    from dimo_tpu_torch.train import optim
    s = trainer.state
    cpu = lambda t: t.detach().cpu().clone()               # noqa: E731
    files = {}
    root = str(trainer.opt.save_path)
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                files[os.path.relpath(path, root)] = f.read()
    return {"params": {k: cpu(v) for k, v in
                       optim.named_leaves(s.params).items()},
            "mu": {k: cpu(v) for k, v in s.opt.mu.items()},
            "nu": {k: cpu(v) for k, v in s.opt.nu.items()},
            "active": cpu(s.aux.active), "c_active": cpu(s.aux.c_active),
            "counters": (trainer.stage, trainer.step, int(s.opt.step)),
            "files": files}


def fingerprint_diff(a: dict, b: dict) -> dict:
    """Where two `run_fingerprint`s differ: {"params" | "mu" | "nu":
    {param group: max |a - b| over its leaves}, "files": [names whose
    bytes differ or that only one run wrote], "other": [differing keys]},
    listing only what is not bit-identical (`torch.equal`); {} when the
    runs are the same bits."""
    from dimo_tpu_torch.train import optim
    out = {}
    for part in ("params", "mu", "nu"):
        groups = {}
        for k in sorted(set(a[part]) | set(b[part])):
            x, y = a[part].get(k), b[part].get(k)
            if x is not None and y is not None and torch.equal(x, y):
                continue
            same_shape = x is not None and y is not None and x.shape == y.shape
            diff = (float((x.double() - y.double()).abs().nan_to_num(
                float("inf")).max()) if same_shape and x.numel()
                    else float("inf"))
            g = optim.leaf_group(k)
            groups[g] = max(groups.get(g, 0.0), diff)
        if groups:
            out[part] = groups
    files = sorted(k for k in set(a["files"]) | set(b["files"])
                   if a["files"].get(k) != b["files"].get(k))
    if files:
        out["files"] = files
    other = [k for k in ("active", "c_active") if not torch.equal(a[k], b[k])]
    other += ["counters"] if a["counters"] != b["counters"] else []
    if other:
        out["other"] = other
    return out
