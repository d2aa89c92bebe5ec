"""LPIPS perceptual distance (VGG16 backbone).

Counterpart of `dimo_tpu/models/lpips.py`, with the same public names and
the same pipeline, quirks included:

  * the inputs go through the scaling layer as they are: [0, 1] images
    into an LPIPS set up for [-1, 1] (the reference's normalize=False);
  * VGG16's 13 3x3 convolutions with SAME padding, a 2x2 max-pool before
    convolutions 2, 4, 7 and 10, taps after relu 1, 3, 6, 9 and 12;
  * each tap unit-normalised over channels with 1e-10 added to the norm,
    the squared difference weighted by a non-negative 1x1 head, the
    spatial mean, then the sum over the five taps.

Weights: an `.npz` with the reference's keys (`conv{i}_w` in (O, I, 3, 3),
`conv{i}_b`, `lin{k}_w`), or the seeded random-VGG fallback, drawn from
`np.random.RandomState(seed)` in the reference's order, so both packages
hold the same numbers. No weight is trained: `LPIPS` keeps them as
buffers, and the `lpips_fn`s below are closures over one such module on
an explicit device.

Precision: float32, forward and backward, on the card as on the CPU.
The reference runs these convolutions at `Precision.DEFAULT` on purpose,
to halve their cost (bf16 on the TPU, float32 on the CPU). The card's
counterpart would be TF32, which cuDNN uses for float32 convolutions when
it is allowed (its global default). Measured on an H100 (`chip_smoke.py`,
4 renders at 512^2 against their GT): TF32 keeps the distances within
8.5e-6 relative of float32 and is 2.6x faster, but moves the input
gradient by 7.05e-2 relative L2, outside the 5e-2 allowed before the
measurement, so float32 ships (`ROADMAP.md` Queue C). Each convolution is
an `autograd.Function` whose forward and backward both set cuDNN's TF32
flag for their own calls (`utils.general.cudnn_tf32`): the backward keeps
the forward's precision whatever the global flags are when
`loss.backward()` runs, and no global flag changes. The same context
restricts cuDNN to deterministic algorithms: the input gradient of one
LPIPS call computed twice differed by up to 2.8e-14 under cuDNN's default
pick (H100, `chip_smoke.py --phase determinism`), and is the same bits
under the restriction. `LPIPS(tf32=True)`
runs both passes in TF32 (the comparison above).

The scaling layer's two constants are copied to the device once per call
of `lpips`, or once per block of `shared_constants()`, in which a train
step calls it once a chunk of whole motions (`train/step.py`).

On the card, everything outside cuDNN's convolutions runs in the
hand-written kernels of `csrc/lpips_fused.cu` (`lpips_fused`): each
convolution's bias, ReLU and, after a tap that a pool follows, the pool in
one epilogue over the convolution's output (`relu_pool`); each tap's head
in one kernel (`tap_head`), which also keeps the two towers' per-pixel
norms; and in the backward each tap layer's convolution-output gradient,
pool backward and head VJP together, in one kernel (`tap_vjp`). The GT
tower runs first under no graph and the rendered tower consumes its taps
layer by layer, each layer one `autograd.Function` (`_ReLULayer`,
`_TapLayer`) that saves the activation, and a tap's GT tap and norms, and
no pool indices. Beside each kernel its plain version (`*_plain`), the
composition of PyTorch ops it replaces: the wrappers run it on a CPU
tensor, and on the CPU `lpips` is `lpips_plain`, the whole composition
under autograd. The recorder counts `lpips_convs` (every VGG convolution)
and `lpips_epilogues` (every epilogue kernel launched): equal counts say
every layer took the fused kernels; on the CPU the epilogues count 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import os

import numpy as np
import torch
import torch.nn.functional as F

from dimo_tpu_torch import build
from dimo_tpu_torch.utils import diagnostics
from dimo_tpu_torch.utils.general import cudnn_tf32, resolve_device

# VGG16 conv plan: (out_channels, pool_before)
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# indices (into the conv list) after whose relu the features are tapped
_TAPS = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)
# the taps that a pool follows: their epilogue also writes the pool
_POOLED = tuple(i for i in range(len(_VGG_PLAN) - 1) if _VGG_PLAN[i + 1][1])
_EPS = 1e-10            # added to each pixel's norm
# a tap kernel's tile is 2 rows x TILE_COLS columns (csrc's kTileCols)
TILE_COLS = 16
# launches of the CUDA kernels since the last reset (chip_smoke reads them);
# a `tap_head` launch is one of tap_head_kernel and one of head_sum_kernel
launches = {"bias_relu": 0, "bias_relu_pool": 0, "tap_head": 0, "tap_vjp": 0}
# x, bias, n, c, h, w, stream
_EPI_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
# x, bias, pooled, n, c, h, w, stream
_POOL_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
# a, b, wt, na, nb, partial, dist, n_partial, n, c, h, w, stream
_HEAD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# y, b, na, nb, wt, gd, gp, out, n, c, h, w, stream
_VJP_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])

_SHIFT = np.array([-.030, -.088, -.188], np.float32)
_SCALE = np.array([.458, .448, .450], np.float32)
# {device: (shift, scale)} inside `shared_constants`, None outside it
_SHARED: dict | None = None


class _Conv3x3(torch.autograd.Function):
    """3x3 convolution, stride 1, padding 1, whose forward and backward
    run with cuDNN's TF32 allowed exactly when `tf32` is true."""

    @staticmethod
    def forward(ctx, x, w, tf32: bool):
        ctx.tf32 = tf32
        ctx.x_shape = x.shape
        # the input is needed only for the weights' gradient
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        with cudnn_tf32(tf32):
            return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with cudnn_tf32(ctx.tf32):
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(ctx.x_shape, w, g, padding=1)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1)
        return gx, gw, None


def vgg_features(params: dict, x: torch.Tensor,
                 tf32: bool = False) -> list[torch.Tensor]:
    """x: (B, 3, H, W) already scaled. Returns the 5 tapped feature maps.
    `tf32` applies to CUDA tensors only. The plain path's tower."""
    tf32 = bool(tf32 and x.is_cuda)
    feats = []
    h = x
    for i, (_, pool_before) in enumerate(_VGG_PLAN):
        if pool_before:
            h = F.max_pool2d(h, 2, 2)
        diagnostics.RECORDER.count("lpips_convs")
        h = torch.relu(_Conv3x3.apply(h, params[f"conv{i}_w"], tf32)
                       + params[f"conv{i}_b"][None, :, None, None])
        if i in _TAPS:
            feats.append(h)
    return feats


@contextlib.contextmanager
def shared_constants():
    """Every `lpips` call inside the block uses one copy of the scaling
    layer's constants on its device, made by the first call there."""
    global _SHARED
    was, _SHARED = _SHARED, {}
    try:
        yield
    finally:
        _SHARED = was


def _constants(dev: torch.device) -> tuple:
    """(shift, scale), (1, 3, 1, 1) each on `dev`."""
    if _SHARED is not None and dev in _SHARED:
        return _SHARED[dev]
    with diagnostics.host_wait("lpips_norm"):
        shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    with diagnostics.host_wait("lpips_norm"):
        scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]
    if _SHARED is not None:
        _SHARED[dev] = (shift, scale)
    return shift, scale


def relu_pool_plain(conv: torch.Tensor, bias: torch.Tensor, pool: bool):
    """Plain version of the epilogue: `conv` overwritten with
    relu(conv + bias), and its 2x2/2 max-pool if `pool` (else None)."""
    y = torch.relu_(conv.add_(bias[None, :, None, None]))
    return y, (F.max_pool2d(y, 2, 2) if pool else None)


def tap_head_plain(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor):
    """Plain version of the head: the (B,) spatial means of sum_c w_c
    (a_c / (|a| + eps) - b_c / (|b| + eps))^2 and the per-pixel norms |a|,
    |b|, (B, 1, H, W) each."""
    na = torch.sqrt(torch.sum(a * a, dim=1, keepdim=True))
    nb = torch.sqrt(torch.sum(b * b, dim=1, keepdim=True))
    d = (a / (na + _EPS) - b / (nb + _EPS)) ** 2
    val = torch.sum(d * w[None, :, None, None], dim=1, keepdim=True)
    return torch.mean(val, dim=(1, 2, 3)), na, nb


def pool_bwd_plain(y: torch.Tensor, gp: torch.Tensor) -> torch.Tensor:
    """The 2x2/2 max-pool's input gradient from its input `y` alone: each
    window's argmax found again by `max_pool2d`'s scan (the first maximum
    in row-major order, a NaN taken where it lies) gets the window's `gp`;
    rows and columns outside every window get zero."""
    n, c, h, w = y.shape
    ho, wo = h // 2, w // 2
    win = (y[:, :, :2 * ho, :2 * wo].reshape(n, c, ho, 2, wo, 2)
           .permute(0, 1, 2, 4, 3, 5).reshape(n, c, ho, wo, 4))
    mx = torch.full(win.shape[:-1], -torch.inf, dtype=y.dtype,
                    device=y.device)
    m = torch.zeros(win.shape[:-1], dtype=torch.long, device=y.device)
    for q in range(4):
        v = win[..., q]
        take = (v > mx) | torch.isnan(v)
        mx = torch.where(take, v, mx)
        m = torch.where(take, q, m)
    g = torch.where(m[..., None] == torch.arange(4, device=y.device),
                    gp[..., None], torch.zeros((), dtype=gp.dtype,
                                               device=gp.device))
    g = (g.reshape(n, c, ho, wo, 2, 2).permute(0, 1, 2, 4, 3, 5)
         .reshape(n, c, 2 * ho, 2 * wo))
    return F.pad(g, (0, w - 2 * wo, 0, h - 2 * ho))


def tap_vjp_plain(y, b, na, nb, w, gd, gp=None) -> torch.Tensor:
    """Plain version of a tap layer's VJP: the gradient at the
    convolution's output of a tap y = relu(conv + bias) against the GT
    tap `b`, given the norms `tap_head` kept, the cotangent `gd` (B,) of
    its distance and `gp` of its pooled map (None where no pool follows):
    (y > 0) * (pool_bwd(gp) + s (r / A - y T / (A^2 |y|))), with s = gd /
    (H W), A = |y| + eps, B = |b| + eps, r = 2 w (y / A - b / B), T =
    sum_c r_c y_c."""
    an, bn = na + _EPS, nb + _EPS
    s = (gd / (y.shape[2] * y.shape[3]))[:, None, None, None]
    r = 2 * w[None, :, None, None] * (y / an - b / bn)
    t = torch.sum(r * y, dim=1, keepdim=True)
    g = s * r / an - y * (s * t / (an * an * na))
    if gp is not None:
        g = pool_bwd_plain(y, gp) + g
    return torch.ops.aten.threshold_backward(g, y, 0)


def _cuda_f32(t: torch.Tensor, what: str, dim: int) -> torch.Tensor:
    """`t` as a contiguous float32 CUDA tensor of `dim` dimensions, or a
    ValueError."""
    if t.dtype != torch.float32 or not t.is_cuda or t.dim() != dim:
        raise ValueError(f"{what}: need a {dim}-D float32 CUDA tensor, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return t if t.is_contiguous() else t.contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def relu_pool(conv: torch.Tensor, bias: torch.Tensor, pool: bool):
    """The epilogue of a VGG convolution: `conv` (B, C, H, W) float32,
    contiguous, overwritten with relu(conv + bias), and, if `pool`, its
    2x2/2 max-pool (B, C, H // 2, W // 2); returns (conv, pooled or None).
    The kernel on a CUDA tensor, the plain version on a CPU one; only a
    launch counts as `lpips_epilogues`."""
    if conv.dtype != torch.float32 or conv.dim() != 4 \
            or not conv.is_contiguous():
        raise ValueError("relu_pool: need a contiguous (B, C, H, W) float32 "
                         f"tensor, got {tuple(conv.shape)} {conv.dtype}")
    if not conv.is_cuda:
        return relu_pool_plain(conv, bias, pool)
    n, c, h, w = conv.shape
    bias = _cuda_f32(bias, "relu_pool bias", 1)
    if bias.shape[0] != c or bias.device != conv.device:
        raise ValueError(f"relu_pool: bias {tuple(bias.shape)} on "
                         f"{bias.device} for {c} channels on {conv.device}")
    pooled = None
    if pool:
        pooled = torch.empty((n, c, h // 2, w // 2), dtype=conv.dtype,
                             device=conv.device)
        fn = build.function("lpips_fused", "lpips_bias_relu_pool",
                            _POOL_ARGTYPES)
        rc = fn(conv.data_ptr(), bias.data_ptr(), pooled.data_ptr(), n, c,
                h, w, _stream(conv))
    else:
        fn = build.function("lpips_fused", "lpips_bias_relu", _EPI_ARGTYPES)
        rc = fn(conv.data_ptr(), bias.data_ptr(), n, c, h, w, _stream(conv))
    build.check(rc, "lpips epilogue")
    launches["bias_relu_pool" if pool else "bias_relu"] += 1
    diagnostics.RECORDER.count("lpips_epilogues")
    return conv, pooled


def _tap_shapes(what: str, a: torch.Tensor, *others) -> None:
    for t in others:
        if t.shape != a.shape or t.device != a.device:
            raise ValueError(f"{what}: {tuple(t.shape)} on {t.device} "
                             f"against {tuple(a.shape)} on {a.device}")


def tap_head(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor):
    """A tap pair's head: (dist (B,), |a| (B, 1, H, W), |b|) as
    `tap_head_plain` gives them. The kernel on CUDA tensors (its sums in
    a fixed order: the same bits every run), the plain version on CPU
    ones."""
    if not a.is_cuda:
        return tap_head_plain(a, b, w)
    a, b = _cuda_f32(a, "tap_head a", 4), _cuda_f32(b, "tap_head b", 4)
    w = _cuda_f32(w, "tap_head w", 1)
    _tap_shapes("tap_head b", a, b)
    n, c, h, wd = a.shape
    if w.shape[0] != c:
        raise ValueError(f"tap_head: head of {w.shape[0]} for {c} channels")
    na = torch.empty((n, 1, h, wd), dtype=a.dtype, device=a.device)
    nb = torch.empty_like(na)
    dist = torch.empty((n,), dtype=a.dtype, device=a.device)
    tiles = ((h + 1) // 2) * (-(-wd // TILE_COLS))
    partial = torch.empty((n * tiles,), dtype=a.dtype, device=a.device)
    fn = build.function("lpips_fused", "lpips_tap_head", _HEAD_ARGTYPES)
    build.check(fn(a.data_ptr(), b.data_ptr(), w.data_ptr(), na.data_ptr(),
                   nb.data_ptr(), partial.data_ptr(), dist.data_ptr(),
                   partial.numel(), n, c, h, wd, _stream(a)), "lpips head")
    launches["tap_head"] += 1
    return dist, na, nb


def tap_vjp(y, b, na, nb, w, gd, gp=None) -> torch.Tensor:
    """A tap layer's convolution-output gradient, as `tap_vjp_plain`
    gives it. The kernel on CUDA tensors, the plain version on CPU
    ones."""
    if not y.is_cuda:
        return tap_vjp_plain(y, b, na, nb, w, gd, gp)
    y, b = _cuda_f32(y, "tap_vjp y", 4), _cuda_f32(b, "tap_vjp b", 4)
    _tap_shapes("tap_vjp b", y, b)
    n, c, h, wd = y.shape
    na, nb = _cuda_f32(na, "tap_vjp na", 4), _cuda_f32(nb, "tap_vjp nb", 4)
    w, gd = _cuda_f32(w, "tap_vjp w", 1), _cuda_f32(gd, "tap_vjp gd", 1)
    if (na.shape != (n, 1, h, wd) or nb.shape != na.shape
            or w.shape[0] != c or gd.shape[0] != n):
        raise ValueError("tap_vjp: norms, head or cotangent do not fit "
                         f"{tuple(y.shape)}")
    if gp is not None:
        gp = _cuda_f32(gp, "tap_vjp gp", 4)
        if gp.shape != (n, c, h // 2, wd // 2):
            raise ValueError(f"tap_vjp: pooled cotangent {tuple(gp.shape)} "
                             f"for {tuple(y.shape)}")
    out = torch.empty_like(y)
    fn = build.function("lpips_fused", "lpips_tap_vjp", _VJP_ARGTYPES)
    build.check(fn(y.data_ptr(), b.data_ptr(), na.data_ptr(), nb.data_ptr(),
                   w.data_ptr(), gd.data_ptr(),
                   None if gp is None else gp.data_ptr(), out.data_ptr(), n,
                   c, h, wd, _stream(y)), "lpips tap VJP")
    launches["tap_vjp"] += 1
    return out


def _conv(x: torch.Tensor, w: torch.Tensor, tf32: bool) -> torch.Tensor:
    """The 3x3 convolution of the fused path, counted; `_Conv3x3`'s
    precision and cuDNN's deterministic algorithms."""
    diagnostics.RECORDER.count("lpips_convs")
    with cudnn_tf32(tf32):
        return F.conv2d(x, w, padding=1)


def _conv_input_grad(ctx, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    with cudnn_tf32(ctx.tf32):
        return torch.nn.grad.conv2d_input(ctx.x_shape, w, g, padding=1)


class _ReLULayer(torch.autograd.Function):
    """A VGG layer whose activation is no tap: relu(conv3x3(x) + bias),
    the epilogue in place over the convolution's output. Saves the
    activation; its backward is ReLU's (`threshold_backward`), then the
    convolution's input gradient."""

    @staticmethod
    def forward(ctx, x, w, bias, tf32: bool):
        ctx.tf32, ctx.x_shape = tf32, x.shape
        y, _ = relu_pool(_conv(x, w, tf32), bias, False)
        ctx.save_for_backward(y, w)
        return y

    @staticmethod
    def backward(ctx, g):
        y, w = ctx.saved_tensors
        g = torch.ops.aten.threshold_backward(g, y, 0)
        return _conv_input_grad(ctx, w, g), None, None, None


class _TapLayer(torch.autograd.Function):
    """A VGG layer that ends in a tap: the convolution, the epilogue (and
    the pool a tap may be followed by) and the tap's head against the GT
    tap `gt`, one node, so that the activation's two consumers have one
    backward (`tap_vjp`). Returns (pooled, dist) where a pool follows,
    else dist. Saves the activation, the GT tap and the two norms."""

    @staticmethod
    def forward(ctx, x, w, bias, lin, gt, tf32: bool, pool: bool):
        ctx.tf32, ctx.x_shape, ctx.pool = tf32, x.shape, pool
        y, pooled = relu_pool(_conv(x, w, tf32), bias, pool)
        dist, na, nb = tap_head(y, gt, lin)
        ctx.save_for_backward(y, gt, na, nb, lin, w)
        return (pooled, dist) if pool else dist

    @staticmethod
    def backward(ctx, *grads):
        gp, gd = grads if ctx.pool else (None, grads[0])
        y, gt, na, nb, lin, w = ctx.saved_tensors
        g = tap_vjp(y, gt, na, nb, lin, gd, gp)
        return _conv_input_grad(ctx, w, g), None, None, None, None, None, None


def lpips_fused(params: dict, img1: torch.Tensor, img2: torch.Tensor,
                tf32: bool = False) -> torch.Tensor:
    """`lpips` through the fused epilogues, heads and tap VJPs (the
    kernels on CUDA tensors, their plain versions on CPU ones):
    differentiable in `img1` only. The GT tower (`img2`) runs first under
    no graph; the rendered tower consumes its taps layer by layer."""
    if torch.is_grad_enabled() and (
            img2.requires_grad or any(v.requires_grad
                                      for v in params.values())):
        raise ValueError("the fused LPIPS differentiates its first image "
                         "only: img2 and the weights must not require grad")
    tf32 = bool(tf32 and img1.is_cuda)
    shift, scale = _constants(img1.device)
    with torch.no_grad():
        # the step's GT is a permuted (channels-last) view: the kernels
        # take NCHW, and so each convolution's output is NCHW
        gt, h = [], ((img2 - shift) / scale).contiguous()
        for i in range(len(_VGG_PLAN)):
            y, pooled = relu_pool(_conv(h, params[f"conv{i}_w"], tf32),
                                  params[f"conv{i}_b"], i in _POOLED)
            if i in _TAPS:
                gt.append(y)
            h = y if pooled is None else pooled
    total, h = 0.0, ((img1 - shift) / scale).contiguous()
    for i in range(len(_VGG_PLAN)):
        w, b = params[f"conv{i}_w"], params[f"conv{i}_b"]
        if i not in _TAPS:
            h = _ReLULayer.apply(h, w, b, tf32)
            continue
        k = _TAPS.index(i)
        out = _TapLayer.apply(h, w, b, params[f"lin{k}_w"], gt[k], tf32,
                              i in _POOLED)
        h, d = out if i in _POOLED else (None, out)
        total = total + d
    return total


def lpips_plain(params: dict, img1: torch.Tensor, img2: torch.Tensor,
                tf32: bool = False) -> torch.Tensor:
    """`lpips` as a composition of PyTorch ops under autograd: the fused
    path's plain version, and the CPU's."""
    shift, scale = _constants(img1.device)
    f1 = vgg_features(params, (img1 - shift) / scale, tf32)
    f2 = vgg_features(params, (img2 - shift) / scale, tf32)
    total = 0.0
    for k, (a, b) in enumerate(zip(f1, f2)):
        total = total + tap_head_plain(a, b, params[f"lin{k}_w"])[0]
    return total


def lpips(params: dict, img1: torch.Tensor, img2: torch.Tensor,
          tf32: bool = False) -> torch.Tensor:
    """img1/img2: (B, 3, H, W) in [0, 1] (fed unnormalised, like the
    reference). Returns (B,) distances: `lpips_fused` on the card,
    `lpips_plain` on the CPU."""
    if img1.is_cuda:
        return lpips_fused(params, img1, img2, tf32)
    return lpips_plain(params, img1, img2, tf32)


class LPIPS(torch.nn.Module):
    """The weights as buffers; calling it gives `lpips(weights, a, b)`."""

    def __init__(self, params: dict, tf32: bool = False):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, torch.as_tensor(v, dtype=torch.float32))
        self.tf32 = tf32

    def weights(self) -> dict:
        return dict(self.named_buffers())

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return lpips(self.weights(), img1, img2, self.tf32)


def _lpips_fn(params: dict, device):
    net = LPIPS(params).to(resolve_device(device))

    def lpips_fn(img1, img2):
        return net(img1, img2)
    return lpips_fn


def load_lpips(path: str, device="cuda"):
    """Converted weights -> lpips_fn(img1, img2), or None."""
    if not path or not os.path.exists(path):
        print(f"[WARN] LPIPS weights not found at {path!r}; LPIPS loss "
              "disabled")
        return None
    from dimo_tpu_torch.io.convert import lpips_params_from_numpy
    with np.load(path) as z:
        params = lpips_params_from_numpy({k: z[k] for k in z.files}, "cpu")
    return _lpips_fn(params, device)


def seeded_lpips_params(seed: int = 0) -> dict:
    """The deterministic random-VGG parameters of the no-weights fallback,
    as CPU tensors, bit-equal to the reference's: He-initialised filters
    from `np.random.RandomState(seed)` drawn in the same order, zero
    biases, uniform non-negative heads of 1/C."""
    rng = np.random.RandomState(seed)
    params = {}
    c_in = 3
    for i, (c_out, _) in enumerate(_VGG_PLAN):
        w = (rng.randn(c_out, c_in, 3, 3).astype(np.float32)
             * np.sqrt(2.0 / (c_in * 9)))
        params[f"conv{i}_w"] = torch.from_numpy(w.astype(np.float32))
        params[f"conv{i}_b"] = torch.zeros((c_out,), dtype=torch.float32)
        c_in = c_out
    for k, c in enumerate(TAP_CHANNELS):
        params[f"lin{k}_w"] = torch.full((c,), 1.0 / c, dtype=torch.float32)
    return params


def random_init_lpips(seed: int = 0, device="cuda"):
    """lpips_fn built from seeded_lpips_params (the fallback, and tests)."""
    return _lpips_fn(seeded_lpips_params(seed), device)


def get_lpips(path: str, fallback: str = "random", seed: int = 0,
              device="cuda"):
    """The training CLI's entry point: converted weights if present, else the
    fallback ('random') or None ('off')."""
    if path and os.path.exists(path):
        return load_lpips(path, device)
    if fallback == "random":
        print(f"[WARN] LPIPS weights not found at {path!r}; using the "
              "deterministic random-VGG perceptual fallback (see "
              "models/lpips.py docstring). Provide lpips_weights for exact "
              "reference parity.")
        return random_init_lpips(seed, device)
    print(f"[WARN] LPIPS weights not found at {path!r} and fallback={fallback!r}; "
          "LPIPS loss disabled")
    return None
