"""Building blocks (port of `rrnet_tpu/models/layers.py:113-419`), NCHW.

Parameters are f32 and are cast to the module's compute dtype on use,
as flax's `promote_dtype` does. Modules allocate their parameters
uninitialised; `init_weights(model, generator)` fills them from a
`torch.Generator` with the JAX package's initialisers, and checkpoints
come in through `utils.from_flax`.

`BatchNorm` follows the module's mode. In eval mode it is the inference
form (`_InferenceBN`, layers.py:192-222): one affine folded from the
running statistics in f32, then cast to the activation dtype. In train
mode it is flax's `nn.BatchNorm` (layers.py:225-246): f32 batch
statistics with the biased variance, used both to normalise and for the
running update `running = 0.9 * running + 0.1 * batch`. With a
data-parallel group set (`set_sync_group`, which `build_model` calls for
the presets with `model.sync_bn`) it is flax's `BatchNorm(axis_name=...)`:
the batch's E[x] and E[x^2] are averaged over the ranks in one
collective before the variance is formed, so every rank normalises and
updates its running statistics with the same synced values.

Every convolution of the port goes through `conv2d`, which runs an f32
convolution at f32 precision in its forward and its backward, whatever
the caller's global TF32 setting (PyTorch lets cuDNN take TF32 for f32
convolutions by default).

int8 post-training quantization (port of layers.py:40-110 and the int8
branch of its `Conv2d`) is a mode, not a change of the parameters:
`quant_context(mode, scales)` sets a context variable that `Conv2d`
reads in its forward. An eligible conv (`quantizable`, groups 1, at
least `min_channels` input channels) records its input's absmax in
"calibrate" mode, and in "int8" mode, given a scale > 0 for its name,
runs `ops.int8_conv.quantize_pack` and `int8_conv2d` on its weight
quantized and packed once (dropped when the weight changes). Names are
the modules' qualified names, set by `name_quant_convs(model)`; they
equal the JAX package's scope paths with "." for "/". A `Conv2d` that
stands in for a flax `nn.Conv` (the stage-1 head towers, RetinaNet's
head, the attention's convs, the trident's convs) is built with
`quantizable=False`, since the JAX package never quantizes those.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from rrnet_torch.ops import int8_conv
from rrnet_torch.parallel.mesh import all_mean
from rrnet_torch.utils import tracing


@contextlib.contextmanager
def cudnn_f32():
    """cuDNN convolutions at full f32 precision (no TF32) inside the
    block; the setting is put back on exit. It sets the convolutions'
    own field: after a mix of that and the legacy `allow_tf32`, PyTorch
    raises on reading `allow_tf32`, so neither is read or set here."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


class _F32Conv(torch.autograd.Function):
    """An f32 convolution whose forward and backward both run inside
    `cudnn_f32`: cuDNN reads its TF32 flag when the backward runs, after
    any scope around the forward call has closed."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (_pair(stride), _pair(padding), _pair(dilation),
                        groups)
        ctx.has_bias = bias is not None
        with cudnn_f32():
            return F.conv2d(x, weight, bias, stride, padding, dilation,
                            groups)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.geometry
        need = ctx.needs_input_grad
        with cudnn_f32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, [weight.shape[0]] if ctx.has_bias else None,
                stride, padding, dilation, False, [0, 0], groups,
                [need[0], need[1], ctx.has_bias and need[2]])
        return gx, gw, gb, None, None, None, None


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """`F.conv2d`; for f32 inputs, at f32 precision in the forward and,
    through `_F32Conv`, in the backward. Other dtypes run as given."""
    if x.dtype != torch.float32:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return _F32Conv.apply(x, weight, bias, stride, padding, dilation,
                              groups)
    with cudnn_f32():
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def torch_conv_init_(w: torch.Tensor, fan_in: int,
                     generator: torch.Generator) -> None:
    """torch's default conv init, U(+-1/sqrt(fan_in)) (the JAX package's
    variance_scaling(1/3, fan_in, uniform))."""
    bound = math.sqrt(1.0 / fan_in)
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


def msra_init_(w: torch.Tensor, fan_out: int,
               generator: torch.Generator) -> None:
    """normal(0, sqrt(2/fan_out)) (variance_scaling(2, fan_out, normal))."""
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of `model` from `generator`, module by
    module in registration order. Returns the model."""
    for m in model.modules():
        if hasattr(m, "reset_parameters_from"):
            m.reset_parameters_from(generator)
    return model


_QUANT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "rrnet_torch_quant", default=None)


class QuantCtx(NamedTuple):
    mode: str                       # "calibrate" | "int8"
    scales: Optional[dict] = None   # {conv name: input absmax}
    min_channels: int = 32          # skip thin-input convs (stems)
    stats: Optional[dict] = None    # calibrate: {conv name: absmax tensor}


@contextlib.contextmanager
def quant_context(mode: str, scales: Optional[dict] = None,
                  min_channels: int = 32):
    """Activate a quantization mode for the forwards run inside the block
    in this thread (a context variable: another thread does not see it).
    "calibrate": eligible convs record their input absmax into the
    yielded context's `stats` (maxed when a conv runs twice). "int8":
    eligible convs whose name has a scale > 0 in `scales` run int8."""
    if mode not in ("calibrate", "int8"):
        raise ValueError(f"unknown quant mode {mode!r}")
    ctx = QuantCtx(mode, scales, min_channels,
                   {} if mode == "calibrate" else None)
    token = _QUANT_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _QUANT_CTX.reset(token)


def current_quant() -> Optional[QuantCtx]:
    return _QUANT_CTX.get()


def quant_scales_from_stats(stats) -> Dict[str, float]:
    """{conv name: absmax} floats from a calibration's `stats` (or a list
    of them, from several calibration passes), maxed over the list."""
    if isinstance(stats, dict):
        stats = [stats]
    names = [k for st in stats for k in st]
    if not names:
        return {}
    values = torch.stack([st[k].float().reshape(()).cpu() for st in stats
                          for k in st]).tolist()
    out: Dict[str, float] = {}
    for k, v in zip(names, values):
        out[k] = max(out.get(k, 0.0), float(v))
    return out


def name_quant_convs(model: nn.Module) -> nn.Module:
    """Give every `Conv2d` of `model` its qualified name, the key of its
    calibration scale. Returns the model."""
    for name, m in model.named_modules():
        if isinstance(m, Conv2d):
            m.quant_name = name
    return model


def drop_int8_weights(model: nn.Module) -> None:
    """Forget every `Conv2d`'s quantized and packed weight (a weight swap
    through `load_state_dict` is also noticed by its version counter)."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m._int8 = None


class Conv2d(nn.Module):
    """Conv with an OIHW f32 weight, computed in `dtype` (the JAX
    Conv2d), with the int8 and calibration modes of `quant_context`
    (module docstring). `groups` is flax's `feature_group_count`: the
    weight is (cout, cin / groups, kh, kw) and the torch init's fan-in
    counts cin / groups, as flax's does on that kernel.
    `quantizable=False` for a conv that stands in for flax's `nn.Conv`.
    `padding`: an int or (ph, pw), symmetric as every JAX Conv2d's."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0,
                 bias: bool = True, init: str = "torch",
                 dtype: torch.dtype = torch.float32, dilation: int = 1,
                 groups: int = 1, quantizable: bool = True):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if cin % groups or cout % groups:
            raise ValueError(f"groups {groups} must divide cin {cin} and "
                             f"cout {cout}")
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.init = init
        self.dtype = dtype
        self.quantizable = quantizable
        self.quant_name: Optional[str] = None
        self._int8 = None       # (weight key, PackedWeight, {absmax: scale})
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        cout, cin, kh, kw = self.weight.shape       # cin per group
        if self.init == "msra":
            msra_init_(self.weight, kh * kw * cout, generator)
        elif self.init == "zeros":
            nn.init.zeros_(self.weight)
        else:
            torch_conv_init_(self.weight, kh * kw * cin, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        q = current_quant()
        if (q is not None and self.quantizable and self.groups == 1
                and x.shape[1] >= q.min_channels):
            name = self.quant_name
            if name is None:
                raise RuntimeError("a Conv2d under a quant context has no "
                                   "name: call name_quant_convs(model)")
            if q.mode == "calibrate":
                amax = x.detach().abs().amax().float()
                prev = q.stats.get(name)
                q.stats[name] = amax if prev is None else torch.maximum(
                    prev, amax)
            elif q.scales is not None and q.scales.get(name, 0.0) > 0:
                return self._int8_forward(x, float(q.scales[name]))
        b = None if self.bias is None else self.bias.to(self.dtype)
        return conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                      self.stride, self.padding, self.dilation, self.groups)

    def pad4(self):
        """The padding per side: (top, bottom, left, right)."""
        ph, pw = _pair(self.padding)
        return (ph, ph, pw, pw)

    def _packed(self):
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._int8 is None or self._int8[0] != key:
            with torch.no_grad():
                self._int8 = (key, int8_conv.pack_weight(w.detach()), {})
        return self._int8

    def packed_weight(self) -> int8_conv.PackedWeight:
        """The weight quantized and packed, made once per weight version."""
        return self._packed()[1]

    def _int8_forward(self, x, absmax: float):
        """The JAX int8 branch: the input as it arrives quantized with
        `absmax`, the weight per output channel, the product exact in
        int32, dequantized into `dtype`, then the bias in `dtype`. The
        packed weight and the dequantize multiplier (and the bias in
        `dtype`) are made once, not every forward."""
        _, packed, per_scale = self._packed()
        s_in = absmax / 127.0
        made = per_scale.get(absmax)
        if made is None:
            with torch.no_grad():
                made = (int8_conv.dequant_scale(packed.s_w, s_in),
                        None if self.bias is None
                        else self.bias.detach().to(self.dtype).contiguous())
            per_scale[absmax] = made
        scale, bias = made
        xq = int8_conv.quantize_pack(x.contiguous(), absmax)
        return int8_conv.int8_conv2d(
            xq, packed, s_in, bias, self.stride, self.pad4(), self.dtype,
            groups=self.groups, dilation=self.dilation, scale=scale)


class BatchNorm(nn.Module):
    """Eval: mul = weight * rsqrt(var + eps), add = bias - mean * mul,
    computed in f32 and applied in the activation dtype. Train: flax's
    batch statistics and running update (module docstring)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.group = None       # parallel.DataGroup of SyncBN, or None
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.zeros_(self.running_mean)
        nn.init.ones_(self.running_var)

    def forward(self, x):
        if self.training:
            return self._train_forward(x)
        mean = self.running_mean
        if torch.is_grad_enabled() and self.weight.requires_grad:
            # autograd saves `mean` for the gradient of `mul`; a copy, so
            # that a train-mode BN updating its statistics in place later
            # in the same forward (they may share one flat tensor, as in
            # the Trainer's state) does not invalidate the saved tensor
            mean = mean.clone()
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - mean * mul
        return (x * mul.to(x.dtype)[:, None, None]
                + add.to(x.dtype)[:, None, None])

    def _train_forward(self, x):
        # statistics in at least f32, as flax's _compute_stats
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        sq = (xf * xf).mean((0, 2, 3))
        if self.group is not None:
            # flax's _compute_stats: one pmean of the stacked moments
            mean, sq = all_mean(torch.stack([mean, sq]), self.group)
        # flax's fast variance E[x^2] - E[x]^2, clipped at 0: biased
        var = (sq - mean * mean).clamp_min(0.0)
        with torch.no_grad():       # in place, as torch's BatchNorm2d
            self.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            self.running_var.mul_(0.9).add_(var, alpha=0.1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


def set_sync_group(model: nn.Module, group) -> nn.Module:
    """Make every `BatchNorm` of `model` a SyncBN over the data-parallel
    `group` (a `parallel.DataGroup`; None for per-rank statistics). Only
    the train form syncs. Returns the model."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model


class ConvBN(nn.Module):
    """kxk conv (+BN) (+ReLU); bias only when BN is off."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, with_bn: bool = True,
                 with_relu: bool = True, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel, stride, (kernel - 1) // 2,
                           bias=not with_bn, dtype=dtype)
        self.bn = BatchNorm(features) if with_bn else None
        self.with_relu = with_relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.with_relu else x


class ResidualBlock(nn.Module):
    """Hourglass residual block (reference hourglass.py:12-40; the JAX
    `layers.ResidualBlock`): 3x3(s)-BN-ReLU-3x3-BN, then `se` where one
    is given (a channel-scaling module, as the SE hourglass's), and a
    1x1(s)-BN skip when the stride or the width changes; ReLU of the sum.
    Torch's conv init. Scopes: `conv1`, `bn1`, `conv2`, `bn2`,
    `skip_conv`, `skip_bn` (and `se`)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype=torch.float32, se: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride, 1, bias=False,
                            dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False,
                            dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.se = se
        if stride != 1 or cin != features:
            self.skip_conv = Conv2d(cin, features, 1, stride, 0, bias=False,
                                    dtype=dtype)
            self.skip_bn = BatchNorm(features)
        else:
            self.skip_conv = None

    def forward(self, x):
        with tracing.span("backbone.block"):
            out = F.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            if self.se is not None:
                out = self.se(out)
            skip = (x if self.skip_conv is None
                    else self.skip_bn(self.skip_conv(x)))
            return F.relu(out + skip)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4, msra init (reference
    resnet.py:17-53)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        cout = planes * 4
        self.conv1 = Conv2d(cin, planes, 1, bias=False, init="msra",
                            dtype=dtype)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False,
                            init="msra", dtype=dtype)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv2d(planes, cout, 1, bias=False, init="msra",
                            dtype=dtype)
        self.bn3 = BatchNorm(cout)
        if stride != 1 or cin != cout:
            self.downsample_conv = Conv2d(cin, cout, 1, stride, bias=False,
                                          init="msra", dtype=dtype)
            self.downsample_bn = BatchNorm(cout)
        else:
            self.downsample_conv = None

    def forward(self, x):
        with tracing.span("backbone.block"):
            out = F.relu(self.bn1(self.conv1(x)))
            out = F.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            skip = (x if self.downsample_conv is None
                    else self.downsample_bn(self.downsample_conv(x)))
            return F.relu(out + skip)


class Linear(nn.Module):
    """flax Dense: (out, in) f32 weight computed in `dtype`, torch conv
    init on the kernel and a zero bias (the JAX package's heads), or
    with init="lecun" flax's own default kernel init, lecun-normal
    (`nn.Dense` left at its defaults); `bias=False` for `use_bias=False`."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 init: str = "torch", dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.init = init
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def reset_parameters_from(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1]
        if self.init == "lecun":
            # variance_scaling(1, fan_in, truncated_normal): the normal
            # cut at two deviations, rescaled to unit variance
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
        elif self.init == "zeros":
            nn.init.zeros_(self.weight)
        else:
            torch_conv_init_(self.weight, fan_in, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def max_pool(x, window: int, stride: int, padding: int):
    """torch MaxPool2d (pads with -inf, as flax's max_pool)."""
    return F.max_pool2d(x, window, stride, padding)


def stem_conv(cin: int, features: int, dtype=torch.float32) -> Conv2d:
    """The 7x7 stride-2 pad-3 stem. The JAX package computes it by
    space-to-depth (`_stem_conv_s2d`, a TPU layout choice);
    tests/test_models.py proves that equal to this plain conv."""
    return Conv2d(cin, features, 7, 2, 3, bias=False, dtype=dtype)


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]
