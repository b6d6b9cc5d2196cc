"""Shared model modules, NCHW (port of `rrnet_tpu/models/modules.py:30-200`):
the 3-level FPN, the windowed `SelfAttentionModule`, `DCNPooling`, and
the bilinear resize that they and the Evaluator use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rrnet_torch.models.layers import BatchNorm, Conv2d, Linear, max_pool
from rrnet_torch.ops.dcn import deform_psroi_pooling


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *size) as `jax.image.resize(...,
    "bilinear")`: half-pixel centres, edges clamped, and a widened
    (antialiased) kernel only where an axis shrinks."""
    size = tuple(size)
    if size == tuple(x.shape[-2:]):
        return x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrinks)


class FPN(nn.Module):
    """3-level feature pyramid (reference modules/fpn.py:5-51): 1x1
    laterals with bias (512/1024/2048 -> channels), the coarser level
    resized to the finer one's size and added, 3x3 smoothing of p4 and
    p3. Module names are the flax scopes (`lat5`, `lat4`, `top4`,
    `lat3`, `top3`)."""

    def __init__(self, in_channels: Tuple[int, int, int] = (512, 1024, 2048),
                 channels: int = 256, dtype=torch.float32):
        super().__init__()
        c3, c4, c5 = in_channels
        self.lat5 = Conv2d(c5, channels, 1, dtype=dtype)
        self.lat4 = Conv2d(c4, channels, 1, dtype=dtype)
        self.top4 = Conv2d(channels, channels, 3, 1, 1, dtype=dtype)
        self.lat3 = Conv2d(c3, channels, 1, dtype=dtype)
        self.top3 = Conv2d(channels, channels, 3, 1, 1, dtype=dtype)

    def forward(self, c3, c4, c5):
        p5 = self.lat5(c5)
        p4 = self.top4(resize_bilinear(p5, c4.shape[-2:]) + self.lat4(c4))
        p3 = self.top3(resize_bilinear(p4, c3.shape[-2:]) + self.lat3(c3))
        return p3, p4, p5


class SelfAttentionModule(nn.Module):
    """Local windowed self-attention (reference modules/self_attention.py
    :7-102; the JAX package's `SelfAttentionModule`). Each query pixel,
    taken at its window's centre, attends over the k x k dilated window
    of keys and values around it: softmax over the k*k taps of the
    unscaled dot products, then the weighted sum of the values.

    Key and query towers: (1x1 conv with bias, BN, ReLU) twice; value: a
    1x1 conv. The towers are flax `nn.Conv`: torch's kernel init and a
    zero bias, as `Conv2d`. The output projection `W` (1x1) starts at
    zero, kernel and bias, so a freshly built module adds exactly 0. The
    result is resized back to the input size (the identity at stride 1
    with "same" padding). Scopes: `f_key_conv1`, `f_key_bn1`, ...,
    `f_query_*`, `f_value`, `W`.

    The JAX package unfolds the windows (`conv_general_dilated_patches`,
    a (B, k*k*C, oh, ow) tensor: 25x the map at RRNet's k = 5). Here each
    tap is a strided view of the zero-padded map, taken in the same
    (row, column) order: per tap one product and channel sum for the
    logits, one product and add for the values, so no window tensor is
    made. The weighted sum of the values accumulates in f32.
    """

    def __init__(self, in_channels: int, key_channels: int = 64,
                 value_channels: int = 64,
                 out_channels: Optional[int] = None, kernel_size: int = 1,
                 dilation: int = 1, padding: int = 0, stride: int = 1,
                 scale: int = 1, dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.padding, self.stride, self.scale = padding, stride, scale
        for name in ("f_key", "f_query"):
            self.add_module(f"{name}_conv1", Conv2d(in_channels, key_channels,
                                                    1, dtype=dtype,
                                                    quantizable=False))
            self.add_module(f"{name}_bn1", BatchNorm(key_channels))
            self.add_module(f"{name}_conv2", Conv2d(key_channels,
                                                    key_channels, 1,
                                                    dtype=dtype,
                                                    quantizable=False))
            self.add_module(f"{name}_bn2", BatchNorm(key_channels))
        self.f_value = Conv2d(in_channels, value_channels, 1, dtype=dtype,
                              quantizable=False)
        self.W = Conv2d(value_channels, out_channels or in_channels, 1,
                        init="zeros", dtype=dtype, quantizable=False)

    def _tower(self, x, name):
        y = F.relu(getattr(self, f"{name}_bn1")(
            getattr(self, f"{name}_conv1")(x)))
        return F.relu(getattr(self, f"{name}_bn2")(
            getattr(self, f"{name}_conv2")(y)))

    def forward(self, x):
        in_hw = tuple(x.shape[-2:])
        if self.scale > 1:
            x = max_pool(x, self.scale, self.scale, 0)
        key = self._tower(x, "f_key")
        query = self._tower(x, "f_query")
        value = self.f_value(x)
        k, d, p, s = self.kernel_size, self.dilation, self.padding, self.stride
        oh = (x.shape[-2] + 2 * p - d * (k - 1) - 1) // s + 1
        ow = (x.shape[-1] + 2 * p - d * (k - 1) - 1) // s + 1
        key = F.pad(key, (p, p, p, p))
        value = F.pad(value, (p, p, p, p))

        def tap(m, i, j):        # the (i, j) tap of every window
            return m[:, :, i * d:i * d + s * (oh - 1) + 1:s,
                     j * d:j * d + s * (ow - 1) + 1:s]

        taps = [(i, j) for i in range(k) for j in range(k)]
        # the query at each window's centre (self_attention.py:84-88)
        start = d * (k // 2) - p
        q = query[:, :, start::s, start::s][:, :, :oh, :ow]
        sim = torch.stack([(tap(key, i, j) * q).sum(1) for i, j in taps], 1)
        sim = torch.softmax(sim, dim=1)                  # (B, k*k, oh, ow)
        context = None
        for t, (i, j) in enumerate(taps):
            c = (tap(value, i, j) * sim[:, t:t + 1]).float()
            context = c if context is None else context + c
        return resize_bilinear(self.W(context.to(value.dtype)), in_hw)


class DCNPooling(nn.Module):
    """Deformable PSROI pooling with a learned per-ROI offset trunk
    (reference ext/dcn/dcn_v2.py:223-303; the JAX package's `DCNPooling`).

    A plain pass (`ops.dcn.deform_psroi_pooling` without offsets), then
    an FC trunk `fc1`, `fc2` (flax's default Dense init, lecun-normal;
    ReLU after each) and `fc3` (zero init, so a fresh module moves
    nothing and its mask is sigmoid(0) = 0.5) on the pooled features
    flattened in (C, ph, pw) order, giving per-bin (x, y) offsets and a
    mask logit; then the pass again with the offsets, times the sigmoid
    mask. `no_trans=True` is the plain pass alone. Plain PyTorch: the
    JAX package computes it in XLA, not with a TPU kernel.

    The JAX module pools every ROI against every image of the batch and
    then picks each ROI's own; here each ROI is pooled on its own image
    only (the batch index truncated and clipped to [0, B - 1]), which
    gives the same result.

    forward(feat (B, C, H, W), rois (R, 5) [batch index, x1, y1, x2,
    y2]) -> (R, output_dim, p, p).
    """

    def __init__(self, spatial_scale: float = 1.0, pooled_size: int = 7,
                 output_dim: int = 256, no_trans: bool = False,
                 group_size: int = 1, part_size: Optional[int] = None,
                 sample_per_part: int = 4, trans_std: float = 0.1,
                 deform_fc_dim: int = 1024, dtype=torch.float32):
        super().__init__()
        self.kw = dict(spatial_scale=spatial_scale, pooled_size=pooled_size,
                       output_dim=output_dim, group_size=group_size,
                       part_size=part_size, sample_per_part=sample_per_part)
        self.no_trans = no_trans
        self.trans_std = trans_std
        if not no_trans:
            p = pooled_size
            self.fc1 = Linear(output_dim * p * p, deform_fc_dim,
                              init="lecun", dtype=dtype)
            self.fc2 = Linear(deform_fc_dim, deform_fc_dim, init="lecun",
                              dtype=dtype)
            self.fc3 = Linear(deform_fc_dim, 3 * p * p, init="zeros",
                              dtype=dtype)

    def forward(self, feat: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        base = deform_psroi_pooling(feat, rois, None, **self.kw)
        if self.no_trans:
            return base
        r, p = rois.shape[0], self.kw["pooled_size"]
        x = F.relu(self.fc1(base.reshape(r, -1)))
        x = F.relu(self.fc2(x))
        x = self.fc3(x).reshape(r, 3, p, p)
        out = deform_psroi_pooling(feat, rois, x[:, :2],
                                   trans_std=self.trans_std, **self.kw)
        return out * torch.sigmoid(x[:, 2:])
