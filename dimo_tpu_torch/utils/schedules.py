"""Learning-rate schedules (float32 scalars).

Counterpart of `dimo_tpu/utils/schedules.py`: the reference's
exponential decay with optional delay (Plenoxels style), evaluated in
float32 as the JAX package evaluates it inside its step. A schedule maps
a step (int or float) to a 0-dim float32 tensor on the CPU; the train
step reads it as a Python float.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def expon_lr(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000):
    """fn(step) -> lr. Constant when init == final, 0 when both are 0, and
    0 before step 0."""
    def helper(step):
        step = _f32(step)
        if lr_init == lr_final:
            return _f32(lr_init) * torch.ones_like(step)
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(step)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_lerp = torch.exp(torch.log(_f32(lr_init)) * (1 - t)
                             + torch.log(_f32(lr_final)) * t)
        lr = delay_rate * log_lerp
        return torch.where(step < 0, torch.zeros_like(lr), lr)
    return helper


def constant_lr(lr: float):
    def helper(step):
        return _f32(lr) * torch.ones_like(_f32(step))
    return helper
