"""Building blocks (port of `rrnet_tpu/models/layers.py:113-419`), on
(N, C, H, W) tensors: NCHW memory in training, channels-last (NHWC)
memory in the eval path.

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

Every convolution of the port is one call, `conv(x, bn, residual=skip,
relu=True)` (`Conv2d.forward`), with the BN after it, the block's
residual and the ReLU where there are any. The BN is an argument of the
call, not a submodule of the conv, so parameter names keep the flax
scopes. `Conv2d.eval_form(bn)` alone decides how the call runs.

In the eval form (neither the conv nor the BN in training mode, no quant
context, no gradient wanted by the pair's parameters) the pair is one
convolution: the BN's eval affine (mul, add) is folded in the
parameters' dtype into the conv's weight (w * mul per output channel)
and bias (add, plus bias * mul), each rounded once to the conv's dtype;
a lone conv's weight and bias are cast to its dtype. They are kept on
the `Conv2d` (`Conv2d.eval_weights`), the weight in `torch.channels_last`
memory. The eval input is channels-last too
(`evallib.infer.Evaluator._normalize` makes it so), and each op of the
body keeps its input's layout, so cuDNN runs every eval convolution in
its native NHWC form, with no layout conversion before or after; an
NCHW input to such a weight comes out channels-last. They are made again
when the data pointer or version counter of a tensor they come from
changes (a `load_state_dict`, an in-place update, of the flat tensor
whose views are the Trainer's parameters too), and dropped by any move
or cast of the module (`.cuda()`, `.cpu()`, `.to()`, `.float()`: each
buffer becomes a new tensor whose version counter starts again at 0, at
an address the allocator may hand out again).

On a CUDA input the eval form's convolution runs without its bias, and
one pass of `ops.conv_epilogue` over its output adds the bias, the
residual and the ReLU, in place. cuDNN's convolution, grouped or not,
adds its bias as a separate elementwise pass, so this equals the eager
chain `relu(conv(x) + skip)` bit for bit. The channels-last weight makes
the output channels-last; the kernel raises on an output or a residual
laid out otherwise. On the CPU, or where a gradient flows through the
input or the residual, eager ops finish it
(`ops.conv_epilogue_reference`). Outside the eval form every step is an
eager op: the conv (int8 or calibrating under a quant context), `bn`,
then the same tail.

The counters (`utils.tracing`) `conv_bn.folded` and `conv_bn.unfolded`
count the pairs run each way, `conv_bn.fold_builds` the folds made, and
`conv_epilogue.kernel` and `conv_epilogue.plain` the convs finished each
way (a conv with no bias, BN, residual or ReLU counts in neither).

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

from rrnet_torch.ops import conv_epilogue as epilogue
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
    """Forget every `Conv2d`'s quantized and packed weight, and its eval
    weight and bias (a weight swap through `load_state_dict` is also
    noticed by the version counters)."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m._int8 = None
            m._eval = None


def _versions(tensors) -> Optional[tuple]:
    """The (data pointer, version) of each tensor (None for an absent
    one), or None where one is an inference tensor, which keeps no
    version counter."""
    try:
        return tuple(None if t is None else (t.data_ptr(), t._version)
                     for t in tensors)
    except RuntimeError:
        return None


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
        self._eval = None       # (key, weight, bias): `eval_weights`
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

    def forward(self, x, bn: Optional["BatchNorm"] = None, residual=None,
                relu: bool = False):
        """`relu(bn(conv(x)) + residual)`, each part where given: in the
        eval form (`eval_form`) one convolution on `eval_weights(bn)`,
        finished on a CUDA input by one `ops.conv_epilogue` pass;
        elsewhere eager ops (module docstring)."""
        finish = (bn is not None or self.bias is not None
                  or residual is not None or relu)
        if self.eval_form(bn):
            if bn is not None:
                tracing.count("conv_bn.folded")
            w, b = self.eval_weights(bn)
            if not x.is_cuda:
                y, b = self.run(x, w, b), None
            else:
                y = self.run(x, w, None)
                if not finish:
                    return y
                if not (y.requires_grad or (residual is not None
                                            and residual.requires_grad)):
                    tracing.count("conv_epilogue.kernel")
                    return epilogue.conv_epilogue(y, b, residual, relu)
        else:
            y, b = self._eager_conv(x), None
            if bn is not None:
                tracing.count("conv_bn.unfolded")
                y = bn(y)
        if finish:
            tracing.count("conv_epilogue.plain")
        return epilogue.conv_epilogue_reference(y, b, residual, relu)

    def eval_form(self, bn: Optional["BatchNorm"] = None) -> bool:
        """Whether this conv, with `bn` after it, runs its eval form:
        neither module in training mode, no quant context, and no
        gradient wanted by their parameters."""
        if self.training or (bn is not None and bn.training) or (
                current_quant() is not None):
            return False
        if not torch.is_grad_enabled():
            return True
        params = (self.weight, self.bias) if bn is None else (
            self.weight, self.bias, bn.weight, bn.bias)
        return not any(p is not None and p.requires_grad for p in params)

    def _eager_conv(self, x):
        """The conv and its bias as eager ops: int8, or recording its
        input's absmax, under a quant context that takes this conv."""
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
        w = self.weight.to(self.dtype)
        return self.run(x, w, None if self.bias is None
                        else self.bias.to(self.dtype))

    def run(self, x, weight, bias):
        """This conv's geometry on `x` in `dtype`, with the given weight
        and bias (already in `dtype`)."""
        return conv2d(x.to(self.dtype), weight, bias, self.stride,
                      self.padding, self.dilation, self.groups)

    def _apply(self, fn, recurse=True):
        # a move or cast gives each buffer a new tensor whose version
        # starts again at 0, maybe at a reused address: no key is safe
        self._eval = self._int8 = None
        return super()._apply(fn, recurse)

    def eval_weights(self, bn: Optional["BatchNorm"] = None):
        """(weight, bias) in `dtype` for a forward without gradients, the
        weight channels-last; with `bn`, its eval affine folded in (module
        docstring). Kept until a tensor they come from changes."""
        src = (self.weight, self.bias) if bn is None else (
            self.weight, self.bias, bn.weight, bn.bias, bn.running_mean,
            bn.running_var)
        key = _versions(src)
        if key is not None:
            key += (self.weight.device, self.weight.dtype, self.dtype)
            if self._eval is not None and self._eval[0] == key:
                return self._eval[1], self._eval[2]
        # plain tensors even inside inference mode, so that a cached
        # weight may later be saved for the backward of an input's grad
        with torch.inference_mode(False), torch.no_grad():
            w, b = self.weight, self.bias
            if bn is not None:
                tracing.count("conv_bn.fold_builds")
                mul, add = bn.affine(bn.running_mean)
                w = w * mul[:, None, None, None]
                b = add if b is None else add + b * mul
            w = w.to(self.dtype, memory_format=torch.channels_last)
            b = None if b is None else b.to(self.dtype)
        if key is not None:
            self._eval = (key, w, b)
        return w, b

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
        mul, add = self.affine(mean)
        return (x * mul.to(x.dtype)[:, None, None]
                + add.to(x.dtype)[:, None, None])

    def affine(self, mean):
        """The eval form's (mul, add) on the running statistics, `mean`
        being `running_mean` or a copy of it."""
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        return mul, self.bias - mean * mul

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
    """kxk conv (+BN) (+ReLU), `groups` as `Conv2d`'s; bias only when BN
    is off. Also the flax `_ConvBNRelu` of HRNet (3x3) and ShuffleNet."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, with_bn: bool = True,
                 with_relu: bool = True, dtype=torch.float32,
                 groups: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel, stride, (kernel - 1) // 2,
                           bias=not with_bn, dtype=dtype, groups=groups)
        self.bn = BatchNorm(features) if with_bn else None
        self.with_relu = with_relu

    def forward(self, x):
        return self.conv(x, self.bn, relu=self.with_relu)


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
            out = self.conv1(x, self.bn1, relu=True)
            skip = (x if self.skip_conv is None
                    else self.skip_conv(x, self.skip_bn))
            if self.se is not None:
                # the SE scale sits between conv2's bias and the add
                return F.relu(self.se(self.conv2(out, self.bn2)) + skip)
            return self.conv2(out, self.bn2, residual=skip, relu=True)


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
            out = self.conv1(x, self.bn1, relu=True)
            out = self.conv2(out, self.bn2, relu=True)
            skip = (x if self.downsample_conv is None
                    else self.downsample_conv(x, self.downsample_bn))
            return self.conv3(out, self.bn3, residual=skip, relu=True)


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
