"""A run with the timed path broken underneath comes out not correct,
under the cells' own limits: a train step that returns its state
unchanged, a train step that leaves out half of its batch and takes its
means over the rest, a render altered inside the train step, and a
served frame altered where it is produced (one card: no exchange between
cards to leave out).
Each drives the rest of a run (the chip's look skipped) on the CPU at a
tiny size; the same run unbroken comes out correct."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from harness import spec as spec_mod


def run(cell, tmp_path, seed=11):
    drv = spec_mod.load_module("drivers", cell["traffic"]["driver"])
    return drv.run(cell, seed, 0.1, False, "cpu", str(tmp_path),
                   time.perf_counter())


def unchanged_state(monkeypatch):
    from dimo_tpu_torch.train import optim
    from dimo_tpu_torch.train.loop import Trainer
    orig = Trainer.get_step_fn

    def get_step_fn(self, *a, **k):
        fn = orig(self, *a, **k)

        def step(state, batch, **kw):
            keep = {n: v.detach().clone()
                    for n, v in optim.named_leaves(state.params).items()}
            mu = {n: v.clone() for n, v in state.opt.mu.items()}
            state, metrics = fn(state, batch, **kw)
            with torch.no_grad():
                for n, v in optim.named_leaves(state.params).items():
                    v.copy_(keep[n])
            state.opt.mu = mu
            return state, metrics
        return step
    monkeypatch.setattr(Trainer, "get_step_fn", get_step_fn)


def half_batch(monkeypatch):
    from dimo_tpu_torch.train.loop import Trainer
    orig = Trainer.get_step_fn

    def get_step_fn(self, stage, res, shape, lpips_fn=None):
        n_m, n_v, n_f = shape
        fn = orig(self, stage, res, (max(1, n_m // 2), n_v, n_f), lpips_fn)
        keep = max(1, n_m // 2) * n_v * n_f

        def step(state, batch, **kw):
            cut = {k: (v[:keep] if k not in ("latent_idx_all",) and
                       hasattr(v, "__len__") and len(v) == n_m * n_v * n_f
                       else v) for k, v in batch.items()}
            cut["latent_idx_all"] = batch["latent_idx_all"][:keep]
            return fn(state, cut, **kw)
        return step
    monkeypatch.setattr(Trainer, "get_step_fn", get_step_fn)


def altered_render(monkeypatch):
    from dimo_tpu_torch.train import step as step_mod
    orig = step_mod.render

    def render(*a, **k):
        out = orig(*a, **k)
        out["image"] = out["image"] * 0.98
        return out
    monkeypatch.setattr(step_mod, "render", render)


@pytest.mark.parametrize("cell_name", ["s2-train-lpips", "s1-train-lpips"])
@pytest.mark.parametrize("fault", [None, "unchanged_state", "half_batch",
                                   "altered_render"])
def test_train_faults(cell_name, fault, monkeypatch, tmp_path):
    torch.set_num_threads(4)
    if fault:
        {"unchanged_state": unchanged_state, "half_batch": half_batch,
         "altered_render": altered_render}[fault](monkeypatch)
    out = run(tiny_cell(cell_name), tmp_path)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "altered_frame"])
def test_serve_faults(fault, monkeypatch, tmp_path):
    torch.set_num_threads(4)
    from dimo_tpu_torch import test_modes
    if fault:
        orig = test_modes._to_u8

        def altered(img):
            out = orig(img)
            out[:8, :8] = 255 - out[:8, :8]
            return out
        monkeypatch.setattr(test_modes, "_to_u8", altered)
    out = run(tiny_cell("s2-serve-seq800"), tmp_path)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] > 0 and np.isfinite(out["checks"][0]["value"])
