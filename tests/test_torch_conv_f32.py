"""f32 convolutions of the port are f32 whatever the global TF32 setting.

PyTorch lets cuDNN run f32 convolutions in TF32 by default, and cuDNN
reads its flag when a convolution runs, the backward's included. Every
convolution of the port goes through `rrnet_torch.models.layers.conv2d`,
which runs an f32 convolution, and through an autograd Function its
backward, with cuDNN's f32 precision pinned to full f32, and then puts the
caller's setting back.

On the CPU the tests check the mechanism: the precision in force as each
convolution op is dispatched (a dispatch mode records it), the setting
restored after, the gradients equal to `F.conv2d`'s, and the port's conv
modules routed through the helper. The `cuda` case holds an f32
convolution and its gradients to f64 on the card at PyTorch's TF32
defaults; it runs there with

    python -m pytest --noconftest -m cuda tests/test_torch_conv_f32.py
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from rrnet_torch.models import layers
from rrnet_torch.models.backbones.trident import SharedConv
from rrnet_torch.models.heads import CenterNetWHHead


def precision():
    """cuDNN's f32 precision for convolutions as PyTorch reports it."""
    return torch.backends.cudnn.conv.fp32_precision


class Spy(TorchDispatchMode):
    """Records (op, precision) for each convolution op dispatched."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("convolution", "convolution_backward"):
            self.seen.append((name, precision()))
        return func(*args, **(kwargs or {}))


def tensors(seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, 3, 9, 11).astype(np.float32))
    w = torch.from_numpy(rng.randn(4, 3, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(4).astype(np.float32))
    ct = torch.from_numpy(rng.randn(2, 4, 9, 9).astype(np.float32))
    return [a.to(dtype) for a in (x, w, b, ct)]


@pytest.fixture
def tf32_default():
    """The TF32 setting PyTorch starts with, restored after the test."""
    prev = precision()
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    yield
    torch.backends.cudnn.conv.fp32_precision = prev


@pytest.mark.parametrize("padding", [(1, 2), (0, 1)])
def test_f32_forward_and_backward_run_pinned(tf32_default, padding):
    x, w, b, _ = tensors()
    x.requires_grad_()
    w.requires_grad_()
    b.requires_grad_()
    before = precision()
    spy = Spy()
    with spy:
        y = layers.conv2d(x, w, b, 1, padding, (1, 2))
        grads = torch.autograd.grad(y, (x, w, b), torch.ones_like(y))
    assert before == "tf32" and precision() == before
    assert [n for n, _ in spy.seen] == ["convolution", "convolution_backward"]
    assert all(p != "tf32" for _, p in spy.seen), spy.seen
    ref = F.conv2d(x, w, b, 1, padding, (1, 2))
    ref_grads = torch.autograd.grad(ref, (x, w, b), torch.ones_like(ref))
    assert torch.equal(y, ref)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def test_no_grad_and_partial_grads(tf32_default):
    x, w, _, _ = tensors(1)
    spy = Spy()
    with spy, torch.no_grad():
        y = layers.conv2d(x, w, None, 2, 1)
    assert spy.seen == [("convolution", spy.seen[0][1])]
    assert spy.seen[0][1] != "tf32"
    assert torch.equal(y, F.conv2d(x, w, None, 2, 1))
    # only the weight needs a gradient: grad x is not computed
    w.requires_grad_()
    gw, = torch.autograd.grad(layers.conv2d(x, w).sum(), (w,))
    rw, = torch.autograd.grad(F.conv2d(x, w).sum(), (w,))
    assert torch.equal(gw, rw)


def test_other_dtypes_run_as_given(tf32_default):
    x, w, b, _ = tensors(2, torch.float64)
    spy = Spy()
    with spy:
        y = layers.conv2d(x, w, b, 1, 1)
    assert spy.seen == [("convolution", "tf32")]
    assert torch.equal(y, F.conv2d(x, w, b, 1, 1))


def test_port_convolutions_go_through_the_helper(tf32_default, monkeypatch):
    calls = []
    real = layers.conv2d

    def counting(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(layers, "conv2d", counting)
    import rrnet_torch.models.backbones.trident as trident
    import rrnet_torch.models.heads as heads
    monkeypatch.setattr(trident, "conv2d", counting)
    monkeypatch.setattr(heads, "conv2d", counting)
    gen = torch.Generator().manual_seed(0)
    conv = layers.init_weights(layers.Conv2d(3, 4, 3, padding=1), gen)
    shared = layers.init_weights(SharedConv(3, 4, kernel=1,
                                            dilations=(1, 1, 1)), gen)
    wh = layers.init_weights(CenterNetWHHead(1, 1, kernel=5, in_channels=3),
                             gen)
    x = tensors()[0]
    conv(x)
    shared([x, x, x])
    wh(x, 0)
    # Conv2d 1, SharedConv 3 branches, the wh head's 3x3 conv and its two
    # asymmetric convs
    assert calls == [torch.float32] * 7


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuDNN's TF32 applies only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_f32_conv_holds_f64_at_the_tf32_defaults(cuda_device,
                                                      tf32_default):
    """Forward and gradients of a 256-channel 3x3 convolution (2304-deep
    sums) within 2e-5 of the largest f64 magnitude; one TF32 pass is
    ~3e-4 there."""
    rng = np.random.RandomState(3)
    x, w, ct = (torch.from_numpy(a).to(cuda_device) for a in (
        rng.randn(4, 256, 32, 32).astype(np.float32),
        (rng.randn(256, 256, 3, 3) / 48.0).astype(np.float32),
        rng.randn(4, 256, 32, 32).astype(np.float32)))
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    y = layers.conv2d(leaves[0], leaves[1], None, 1, 2, 2)
    grads = torch.autograd.grad(y, leaves, ct)
    leaves64 = [a.double().requires_grad_() for a in (x, w)]
    y64 = F.conv2d(leaves64[0], leaves64[1], None, 1, 2, 2)
    grads64 = torch.autograd.grad(y64, leaves64, ct.double())
    assert precision() == "tf32"
    for got, ref in [(y, y64)] + list(zip(grads, grads64)):
        err = float((got.double() - ref).abs().max() / ref.abs().max())
        assert err <= 2e-5, err
