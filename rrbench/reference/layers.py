"""Plain building blocks of the reference, NCHW, float32.

A frozen copy of the port's plain model code (its `models.layers`,
without the int8 mode and the data-parallel sync), so the yardstick does
not move when the port's modules change. Parameter and buffer names
equal the port's, so one state dict loads into both.

Every convolution and dense layer computes in float32 with TF32 off (`f32_numerics`), or, with the module's
`fp8` flag set (`set_fp8`), on inputs and weights rounded to float8 e4m3
with one scale a tensor: the control, one precision below the bfloat16
the configurations state.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0     # largest finite float8 e4m3fn


@contextlib.contextmanager
def f32_numerics():
    """Float32 matmuls and convolutions at full precision (no TF32)
    inside the block; the settings are put back on exit."""
    conv = torch.backends.cudnn.conv
    mm = torch.backends.cuda.matmul
    prev = conv.fp32_precision, mm.fp32_precision
    conv.fp32_precision = "ieee"
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision, mm.fp32_precision = prev


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its
    absolute max onto 448), returned in float32; the gradient passes
    through the rounding unchanged (straight through)."""
    x = x.float()
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q - x.detach())


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    """Run every conv and dense layer of `model` on fp8-rounded inputs and
    weights (the control). Returns the model."""
    for m in model.modules():
        if hasattr(m, "fp8"):
            m.fp8 = on
    return model


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           fp8: bool = False):
    if fp8:
        x, weight = fp8_round(x), fp8_round(weight)
    return F.conv2d(x.float(), weight.float(), bias, stride, padding,
                    dilation, groups)


class Conv2d(nn.Module):
    """Conv with an OIHW weight; `padding` an int or (ph, pw)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 bias: bool = True, dilation: int = 1, groups: int = 1):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.fp8 = False
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, fp8=self.fp8)


class Linear(nn.Module):
    """Dense layer with an (out, in) weight."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.fp8 = False
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        w = self.weight
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        return F.linear(x.float(), w.float(), self.bias)


class BatchNorm(nn.Module):
    """Eval: the affine folded from the running statistics. Train: the
    biased batch statistics, E[x^2] - E[x]^2 clipped at 0, used to
    normalise and for `running = 0.9 * running + 0.1 * batch`."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x):
        if not self.training:
            mul = self.weight * torch.rsqrt(self.running_var + self.eps)
            add = self.bias - self.running_mean * mul
            return x * mul[:, None, None] + add[:, None, None]
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(0.9).add_(mean.detach(), alpha=0.1)
            self.running_var.mul_(0.9).add_(var.detach(), alpha=0.1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class ConvBN(nn.Module):
    """kxk conv (+BN) (+ReLU); bias only when BN is off."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, with_bn: bool = True,
                 with_relu: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel, stride, (kernel - 1) // 2,
                           bias=not with_bn)
        self.bn = BatchNorm(features) if with_bn else None
        self.with_relu = with_relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.with_relu else x


class ResidualBlock(nn.Module):
    """3x3(s)-BN-ReLU-3x3-BN, a 1x1(s)-BN skip where the shape changes,
    ReLU of the sum."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        if stride != 1 or cin != features:
            self.skip_conv = Conv2d(cin, features, 1, stride, 0, bias=False)
            self.skip_bn = BatchNorm(features)
        else:
            self.skip_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        skip = x if self.skip_conv is None else self.skip_bn(self.skip_conv(x))
        return F.relu(out + skip)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.downsample_conv = Conv2d(cin, cout, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(cout)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        skip = (x if self.downsample_conv is None
                else self.downsample_bn(self.downsample_conv(x)))
        return F.relu(out + skip)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source index of each output position of a nearest resize:
    floor((i + 0.5) * n_in / n_out) in float32."""
    pos = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    return torch.floor(pos * n_in / n_out).long()


def resize_nearest(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return (x.index_select(-2, _nearest_index(h, oh, x.device))
            .index_select(-1, _nearest_index(w, ow, x.device)))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Half-pixel bilinear resize, antialiased only where an axis
    shrinks."""
    size = tuple(size)
    if size == tuple(x.shape[-2:]):
        return x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrinks)


def resize_bilinear_align_corners(x: torch.Tensor, oh: int,
                                  ow: int) -> torch.Tensor:
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=True)

