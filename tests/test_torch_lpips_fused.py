"""The fused LPIPS path (`dimo_tpu_torch/models/lpips.py::lpips_fused`) on
the CPU, where its kernels' wrappers run their plain versions, held
against today's composition of PyTorch ops:

  * the epilogue and pool bit-equal to torch.relu(conv + bias) and
    max_pool2d, at even and odd H and W, with ties and NaNs, and the
    pool's backward found again from its input bit-equal to autograd's;
  * the head within 1e-6 relative of a float64 evaluation;
  * a tap layer's VJP (pool backward + head VJP + ReLU mask) within 1e-6
    relative L2 of autograd over the plain ops;
  * the whole call's distances bit-equal to `lpips_plain` and its input
    gradient within 1e-6 relative L2;
  * the counters: `lpips_convs` counts every convolution, and
    `lpips_epilogues` only kernel launches (none on the CPU).

The kernels themselves run on the card only: `chip_smoke.py` phase 6d
(`--phase lpips`) holds them to these plain versions there.
"""
import pytest
import torch
import torch.nn.functional as F

from dimo_tpu_torch.models import lpips as L
from dimo_tpu_torch.utils import diagnostics

from torch_parity import one_torch_thread  # noqa: F401

SHAPES = [(2, 5, 8, 6), (2, 5, 7, 9), (1, 3, 5, 4)]
IDS = ["even", "odd", "odd-rows"]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _rel_l2(got, ref):
    return float((got - ref).norm() / ref.norm())


def _conv_like(shape, seed, nan=True):
    """Values on a grid of 1/4 (ties in many windows), a few NaNs."""
    g = torch.Generator().manual_seed(seed)
    x = torch.round(4 * torch.randn(shape, generator=g)) / 4
    if nan:
        x.view(-1)[::23] = float("nan")
    return x


def _params(seed=0):
    """The seeded VGG with biases drawn non-zero (trained weights have
    them; the fallback's are zero)."""
    p = L.seeded_lpips_params(seed)
    g = torch.Generator().manual_seed(seed + 1)
    for i in range(len(L._VGG_PLAN)):
        b = p[f"conv{i}_b"]
        p[f"conv{i}_b"] = 0.05 * torch.randn(b.shape, generator=g)
    return p


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no-pool"])
def test_epilogue_and_pool_are_todays_ops_bit_for_bit(shape, pool):
    conv = _conv_like(shape, 0)
    bias = torch.round(4 * torch.randn(shape[1])) / 8
    ref = torch.relu(conv + bias[None, :, None, None])
    y, p = L.relu_pool(conv.clone(), bias, pool)
    assert torch.equal(_bits(y), _bits(ref))
    if pool:
        assert torch.equal(_bits(p), _bits(F.max_pool2d(ref, 2, 2)))
    else:
        assert p is None


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_pool_backward_finds_autograds_argmax(shape):
    """Ties go to the first maximum in scan order, a NaN where it lies,
    rows and columns outside every window get nothing: the gradient that
    max_pool2d's stored indices give, bit for bit."""
    y = torch.relu(_conv_like(shape, 1))
    g = torch.Generator().manual_seed(2)
    n, c, h, w = shape
    gp = torch.randn((n, c, h // 2, w // 2), generator=g)
    x = y.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad(torch.sum(F.max_pool2d(x, 2, 2) * gp), x)
    assert torch.equal(_bits(L.pool_bwd_plain(y, gp)), _bits(ref))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_head_is_the_float64_head(shape):
    g = torch.Generator().manual_seed(3)
    a = torch.relu(torch.randn(shape, generator=g))
    b = torch.relu(torch.randn(shape, generator=g))
    w = torch.rand(shape[1], generator=g) / shape[1]
    dist, na, nb = L.tap_head(a, b, w)
    a64, b64, w64 = a.double(), b.double(), w.double()
    n64 = [t.norm(dim=1, keepdim=True) for t in (a64, b64)]
    d64 = ((a64 / (n64[0] + 1e-10) - b64 / (n64[1] + 1e-10)) ** 2
           * w64[None, :, None, None]).sum(1).mean((1, 2))
    torch.testing.assert_close(dist.double(), d64, rtol=1e-6, atol=0)
    torch.testing.assert_close(na.double(), n64[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(nb.double(), n64[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "last-tap"])
def test_tap_vjp_is_autograd_of_the_plain_ops(shape, pool):
    """The convolution-output gradient of relu(conv + bias), its pool and
    its head together: ties in the pool's windows, zeros under the ReLU."""
    g = torch.Generator().manual_seed(4)
    n, c, h, w = shape
    conv = _conv_like(shape, 5, nan=False)
    bias = torch.randn(c, generator=g) * 0.1
    gt = torch.relu(torch.randn(shape, generator=g))
    lin = torch.rand(c, generator=g) / c
    gd = torch.rand(n, generator=g)
    gp = torch.randn((n, c, h // 2, w // 2), generator=g) if pool else None
    x = conv.clone().requires_grad_(True)
    y = torch.relu(x + bias[None, :, None, None])
    d, na, nb = L.tap_head_plain(y, gt, lin)
    loss = torch.sum(d * gd)
    if pool:
        loss = loss + torch.sum(F.max_pool2d(y, 2, 2) * gp)
    (ref,) = torch.autograd.grad(loss, x)
    got = L.tap_vjp(y.detach(), gt, na.detach(), nb.detach(), lin, gd, gp)
    assert _rel_l2(got, ref) <= 1e-6
    off = (y <= 0).detach()
    assert torch.all(got[off] == 0) and torch.all(ref[off] == 0)


def test_fused_call_is_the_plain_call():
    """Distances bit-equal (the same ops in the same order), the input
    gradient within 1e-6 relative L2 (the VJP sums in its own order);
    `tf32` is the convolutions' only, and the CPU has none."""
    p = _params()
    g = torch.Generator().manual_seed(6)
    a = torch.rand((2, 3, 40, 36), generator=g)
    b = (0.8 * a + 0.2 * torch.rand(a.shape, generator=g))
    grads = {}
    for name, fn in (("plain", L.lpips_plain), ("fused", L.lpips_fused)):
        x = a.clone().requires_grad_(True)
        d = fn(p, x, b)
        grads[name] = (d.detach(), torch.autograd.grad(torch.sum(d), x)[0])
    assert torch.equal(grads["fused"][0], grads["plain"][0])
    assert _rel_l2(grads["fused"][1], grads["plain"][1]) <= 1e-6
    assert torch.equal(L.lpips_fused(p, a, b, tf32=True), grads["plain"][0])
    # the train step's GT is a channels-last view; the epilogue takes only
    # contiguous NCHW, as the kernel does
    b_nhwc = b.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    assert torch.equal(L.lpips_fused(p, a, b_nhwc), grads["plain"][0])
    with pytest.raises(ValueError, match="contiguous"):
        L.relu_pool(b_nhwc.clone(memory_format=torch.channels_last),
                    torch.zeros(3), False)


def test_counters_count_convs_and_only_launched_epilogues(monkeypatch):
    """Both calls run 26 convolutions; `lpips_epilogues` counts kernel
    launches, so neither call counts one on the CPU (on the card the fused
    call counts 26, `chip_smoke.py --phase lpips`), nor any launch."""
    monkeypatch.setattr(diagnostics, "RECORDER", diagnostics.Recorder())
    launches = dict(L.launches)
    p = L.seeded_lpips_params(0)
    a = torch.rand((1, 3, 32, 32))
    with diagnostics.tracing():
        for step, fn in enumerate((L.lpips_fused, L.lpips_plain)):
            with diagnostics.span("step", step):
                fn(p, a, a.flip(2))
    fused, plain = diagnostics.step_totals(2)
    assert (fused["lpips_epilogues"], fused["lpips_convs"]) == (0, 26)
    assert (plain["lpips_epilogues"], plain["lpips_convs"]) == (0, 26)
    assert L.launches == launches


def test_fused_call_refuses_what_it_cannot_differentiate():
    p = L.seeded_lpips_params(0)
    a = torch.rand((1, 3, 16, 16))
    with pytest.raises(ValueError, match="first image only"):
        L.lpips_fused(p, a, a.clone().requires_grad_(True))
    p["lin0_w"].requires_grad_(True)
    with pytest.raises(ValueError, match="first image only"):
        L.lpips_fused(p, a, a)
    with torch.no_grad():
        assert L.lpips_fused(p, a, a).shape == (1,)
