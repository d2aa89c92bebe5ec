"""Observability hooks: step timing, profiler traces, NaN checks.

Counterpart of `dimo_tpu/utils/diagnostics.py`: `StepTimer` waits for
the card where the reference blocks on its arrays, `profile_trace` is a
`torch.profiler` trace (CPU and, where there is a card, CUDA activity)
written as a Chrome trace, and the NaN checks are autograd's anomaly
mode. `device_busy_share` reads such a trace: the share of a window that
the card spent in kernels.
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch


def _cuda_tensors(x):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _cuda_tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _cuda_tensors(v)


class StepTimer:
    """Wall-clock per-step timing with an EMA; `stop(result)` waits for
    the card first when `result` holds a CUDA tensor."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema_ms = None
        self.last_ms = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if next(_cuda_tensors(result), None) is not None:
            torch.cuda.synchronize()
        self.last_ms = (time.perf_counter() - self._t0) * 1000.0
        self.ema_ms = (self.last_ms if self.ema_ms is None
                       else (1 - self.alpha) * self.ema_ms
                       + self.alpha * self.last_ms)
        return self.last_ms

    @property
    def steps_per_sec(self) -> float:
        return 1000.0 / self.ema_ms if self.ema_ms else 0.0


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
