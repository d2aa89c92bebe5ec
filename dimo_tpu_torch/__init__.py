"""DIMO on PyTorch + CUDA: the H100 port of the `dimo_tpu` JAX package.

The layout mirrors `dimo_tpu/` module for module, so each counterpart is
easy to find. The JAX package stays the reference: every module here is
held against it on the CPU by `tests/test_torch_*.py`, and every CUDA
kernel (under `csrc/`) is held against its plain PyTorch version on the
card by `chip_smoke.py`.

Layers (bottom-up):
  csrc/      hand-written CUDA C++ kernels for sm_90a (built by `build.py`):
             the strip compositor and its backward (K1, K3), the LBS
             column gather and its scatter-add backward (K2, K4)
  ops/       plain-tensor math + kernel wrappers with autograd (rasterizer,
             LBS gather), image losses, ARAP, neighbours, and the JAX
             gradient conventions at kinks (`grad_conventions.py`)
  models/    Gaussians, TimeNet, KNN-LBS deformation, the renderer,
             LPIPS (VGG16)
  train/     per-group Adam, the s1/s2 train steps, the two-stage trainer
  parallel/  process groups over torch.distributed: data parallelism of
             the train step, spatial sharding of one render
  io/        weight and optimizer-state conversion from the JAX package's
             numpy leaves, checkpoints, PLY, config, synthetic videos,
             datasets, the native PLY codec and batch packer
  utils/     cameras (numpy), LR schedules, diagnostics (step timer,
             profiler trace, NaN checks), small helpers

Entry points take `device=` and default to "cuda"; the CPU runs only
where a caller asks for it (the tests do).
"""
import torch as _torch

__version__ = "0.1.0"

# The reference forces float32 matmuls (`dimo_tpu/__init__.py:33`); keep
# TF32 off so fp32 products on the card stay fp32 (PyTorch's matmul default,
# stated here so no other import can flip it silently). cuDNN runs two
# things, each at a precision it sets for its own calls and no global cuDNN
# flag: SSIM's blur in float32 (`ops/image_losses.py`), LPIPS's VGG
# convolutions in float32, forward and backward (`models/lpips.py`).
_torch.backends.cuda.matmul.allow_tf32 = False
