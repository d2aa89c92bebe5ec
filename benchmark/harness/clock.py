"""Timestamps on the device's own clock (CUDA events) where there is a
card, on the host's otherwise (the CPU runs of the benchmark's tests)."""
from __future__ import annotations

import time

import torch


class Clock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def seconds(self, a, b) -> float:
        """Seconds from mark a to mark b (after a synchronize)."""
        return a.elapsed_time(b) * 1e-3 if self.cuda else b - a

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()
