"""The plain reference of RRNet: the stacked hourglass, HRNetV2 with the
windowed self-attention, the stage-1 heads, decode, hard NMS, ROI-align
and the stage-2 regressor, float32 throughout.

A frozen copy of the port's plain model code (its `models.rrnet`,
`models.heads`, `models.modules`, `models.backbones.hourglass`,
`models.backbones.hrnet`) with the NMS kernel replaced by the plain
fixpoint of `ops.hard_nms`. Module names are the port's, so the port's
state dict loads here as it is.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rrbench.reference import ops
from rrbench.reference.layers import (BatchNorm, Bottleneck, Conv2d, ConvBN,
                                      Linear, ResidualBlock, conv2d,
                                      resize_bilinear,
                                      resize_bilinear_align_corners,
                                      resize_nearest)


# ---------------------------------------------------------------- hourglass

class Hourglass(nn.Module):
    """One recursive hourglass: stride-2 residual down path, nearest x2
    up path."""

    def __init__(self, n: int, inplanes: Sequence[int],
                 layer_nums: Sequence[int], cin: int):
        super().__init__()
        cur, nxt = inplanes[0], inplanes[1]
        self.n, self.cur_num, self.nxt_num = n, layer_nums[0], layer_nums[1]
        for i in range(self.cur_num):
            self.add_module(f"up1_{i}", ResidualBlock(cin if i == 0 else cur,
                                                      cur))
        self.add_module("low1_0", ResidualBlock(cin, nxt, stride=2))
        for i in range(1, self.cur_num):
            self.add_module(f"low1_{i}", ResidualBlock(nxt, nxt))
        if n > 1:
            self.low2 = Hourglass(n - 1, inplanes[1:], layer_nums[1:], nxt)
        else:
            for i in range(self.nxt_num):
                self.add_module(f"low2_{i}", ResidualBlock(nxt, nxt))
        for i in range(self.cur_num - 1):
            self.add_module(f"low3_{i}", ResidualBlock(nxt, nxt))
        self.add_module(f"low3_{self.cur_num - 1}", ResidualBlock(nxt, cur))

    def forward(self, x):
        up1 = x
        for i in range(self.cur_num):
            up1 = getattr(self, f"up1_{i}")(up1)
        low = self.low1_0(x)
        for i in range(1, self.cur_num):
            low = getattr(self, f"low1_{i}")(low)
        if self.n > 1:
            low = self.low2(low)
        else:
            for i in range(self.nxt_num):
                low = getattr(self, f"low2_{i}")(low)
        for i in range(self.cur_num):
            low = getattr(self, f"low3_{i}")(low)
        return up1 + resize_nearest(low, *up1.shape[-2:])


class HourglassNet(nn.Module):
    """The plain stacked hourglass: one `num_feats` stride-4 map a
    stack."""

    def __init__(self, num_stacks: int = 2, depth: int = 5,
                 inplanes: Sequence[int] = (256, 256, 384, 384, 384, 512),
                 layer_nums: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 num_feats: int = 256):
        super().__init__()
        self.num_stacks = num_stacks
        self.out_channels = (num_feats,) * num_stacks
        self.pre_conv = Conv2d(3, 128, 7, 2, 3, bias=False)
        self.pre_bn = BatchNorm(128)
        self.pre_res = ResidualBlock(128, 256, stride=2)
        c0, cin = inplanes[0], 256
        for i in range(num_stacks):
            self.add_module(f"hg{i}", Hourglass(depth, inplanes, layer_nums,
                                                cin))
            self.add_module(f"out_conv{i}", ConvBN(c0, num_feats, 3,
                                                   with_relu=False))
            if i < num_stacks - 1:
                self.add_module(f"inter{i}", ConvBN(cin, c0, 1,
                                                    with_relu=False))
                self.add_module(f"fuse{i}", ConvBN(num_feats, c0, 1,
                                                   with_relu=False))
                self.add_module(f"inter_res{i}", ResidualBlock(c0, c0))
                cin = c0

    def forward(self, x) -> List[torch.Tensor]:
        pre = self.pre_res(F.relu(self.pre_bn(self.pre_conv(x))))
        outs = []
        for i in range(self.num_stacks):
            feat = getattr(self, f"out_conv{i}")(getattr(self, f"hg{i}")(pre))
            outs.append(feat)
            if i < self.num_stacks - 1:
                a = getattr(self, f"inter{i}")(pre)
                b = getattr(self, f"fuse{i}")(F.relu(feat))
                pre = getattr(self, f"inter_res{i}")(F.relu(a + b))
        return outs


# -------------------------------------------------------------------- HRNet

class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        if stride != 1 or cin != planes:
            self.down_conv = Conv2d(cin, planes, 1, stride, bias=False)
            self.down_bn = BatchNorm(planes)
        else:
            self.down_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        skip = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(out + skip)


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 relu: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn = BatchNorm(features)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class StageModule(nn.Module):
    """BasicBlocks on each branch, then every branch fused into each
    output: identity, 1x1 conv + BN + nearest upsample, or a chain of
    stride-2 3x3 conv + BN (+ ReLU but the last)."""

    def __init__(self, channels: Sequence[int], num_blocks: int = 4,
                 output_branches: Optional[int] = None):
        super().__init__()
        n = len(channels)
        self.n, self.n_out, self.num_blocks = n, output_branches or n, \
            num_blocks
        for j in range(n):
            for b in range(num_blocks):
                self.add_module(f"branch{j}_block{b}",
                                BasicBlock(channels[j], channels[j]))
        for i in range(self.n_out):
            for j in range(n):
                if i < j:
                    self.add_module(f"fuse{i}_{j}_conv", Conv2d(
                        channels[j], channels[i], 1, bias=False))
                    self.add_module(f"fuse{i}_{j}_bn", BatchNorm(channels[i]))
                elif i > j:
                    for k in range(i - j):
                        last = k == i - j - 1
                        self.add_module(f"fuse{i}_{j}_down{k}", ConvBNRelu(
                            channels[j], channels[i] if last else channels[j],
                            stride=2, relu=not last))

    def forward(self, xs):
        xs = list(xs)
        for j in range(self.n):
            for b in range(self.num_blocks):
                xs[j] = getattr(self, f"branch{j}_block{b}")(xs[j])
        fused = []
        for i in range(self.n_out):
            acc = None
            for j in range(self.n):
                if i == j:
                    y = xs[j]
                elif i < j:
                    y = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(xs[j]))
                    y = resize_nearest(y, *xs[i].shape[-2:])
                else:
                    y = xs[j]
                    for k in range(i - j):
                        y = getattr(self, f"fuse{i}_{j}_down{k}")(y)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNetV2(nn.Module):
    """HRNetV2: the stem, `layer1`, stages 2-4 on (c, 2c, 4c, 8c)
    branches, all four kept and upsampled to stride 4 with aligned
    corners. Its batch norms stay on their running statistics when the
    model trains (`norm_eval`)."""

    def __init__(self, base_channels: int = 40,
                 stage_modules: Tuple[int, int, int] = (1, 4, 3)):
        super().__init__()
        c = base_channels
        w = (c, 2 * c, 4 * c, 8 * c)
        self.stage_modules = tuple(stage_modules)
        self.out_channels = w
        self.stem1 = ConvBNRelu(3, 64, stride=2)
        self.stem2 = ConvBNRelu(64, 64, stride=2)
        for b in range(4):
            self.add_module(f"layer1_{b}", Bottleneck(64 if b == 0 else 256,
                                                      64))
        self.trans1_0 = ConvBNRelu(256, w[0])
        self.trans1_1 = ConvBNRelu(256, w[1], stride=2)
        n2, n3, n4 = self.stage_modules
        for m in range(n2):
            self.add_module(f"stage2_{m}", StageModule(w[:2]))
        self.trans2_2 = ConvBNRelu(w[1], w[2], stride=2)
        for m in range(n3):
            self.add_module(f"stage3_{m}", StageModule(w[:3]))
        self.trans3_3 = ConvBNRelu(w[2], w[3], stride=2)
        for m in range(n4):
            self.add_module(f"stage4_{m}", StageModule(w))

    def train(self, mode: bool = True):
        return super().train(False)

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem2(self.stem1(x))
        for b in range(4):
            x = getattr(self, f"layer1_{b}")(x)
        xs = [self.trans1_0(x), self.trans1_1(x)]
        n2, n3, n4 = self.stage_modules
        for m in range(n2):
            xs = getattr(self, f"stage2_{m}")(xs)
        xs = xs + [self.trans2_2(xs[-1])]
        for m in range(n3):
            xs = getattr(self, f"stage3_{m}")(xs)
        xs = xs + [self.trans3_3(xs[-1])]
        for m in range(n4):
            xs = getattr(self, f"stage4_{m}")(xs)
        oh, ow = xs[0].shape[-2:]
        return [xs[0]] + [resize_bilinear_align_corners(xs[i], oh, ow)
                          for i in range(1, 4)]


# ------------------------------------------------------------ attention

class SelfAttentionModule(nn.Module):
    """Each query pixel attends over the k x k dilated window of keys and
    values around it: softmax over the taps of the unscaled dot
    products, the weighted sum of the values, a 1x1 projection `W`."""

    def __init__(self, in_channels: int, key_channels: int = 64,
                 value_channels: int = 64, kernel_size: int = 5,
                 dilation: int = 6, padding: int = 12):
        super().__init__()
        self.k, self.d, self.p = kernel_size, dilation, padding
        for name in ("f_key", "f_query"):
            self.add_module(f"{name}_conv1", Conv2d(in_channels,
                                                    key_channels, 1))
            self.add_module(f"{name}_bn1", BatchNorm(key_channels))
            self.add_module(f"{name}_conv2", Conv2d(key_channels,
                                                    key_channels, 1))
            self.add_module(f"{name}_bn2", BatchNorm(key_channels))
        self.f_value = Conv2d(in_channels, value_channels, 1)
        self.W = Conv2d(value_channels, in_channels, 1)

    def _tower(self, x, name):
        y = F.relu(getattr(self, f"{name}_bn1")(
            getattr(self, f"{name}_conv1")(x)))
        return F.relu(getattr(self, f"{name}_bn2")(
            getattr(self, f"{name}_conv2")(y)))

    def forward(self, x):
        k, d, p = self.k, self.d, self.p
        key = self._tower(x, "f_key")
        query = self._tower(x, "f_query")
        value = self.f_value(x)
        h, w = x.shape[-2:]
        oh, ow = h + 2 * p - d * (k - 1), w + 2 * p - d * (k - 1)
        # the windows, unfolded: (B, C, k*k, oh*ow), taps in row order
        kw = F.unfold(key, k, dilation=d, padding=p)
        vw = F.unfold(value, k, dilation=d, padding=p)
        b, ck = key.shape[:2]
        kw = kw.reshape(b, ck, k * k, oh * ow)
        vw = vw.reshape(b, value.shape[1], k * k, oh * ow)
        start = d * (k // 2) - p
        q = query[:, :, start:, start:][:, :, :oh, :ow].reshape(b, ck, 1, -1)
        sim = torch.softmax((kw * q).sum(1), dim=1)      # (B, k*k, oh*ow)
        context = (vw * sim[:, None]).sum(2).reshape(b, -1, oh, ow)
        return resize_bilinear(self.W(context), (h, w))


# ----------------------------------------------------------------- heads

class ConvParam(nn.Module):
    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.fp8 = False
        self.weight = nn.Parameter(torch.empty(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.empty(cout))


class CenterNetHead(nn.Module):
    """Per stack: 3x3 conv + ReLU, then a 1x1 out conv; NHWC out."""

    def __init__(self, planes: int, widths: Sequence[int], mid: int = 256):
        super().__init__()
        for i, cin in enumerate(widths):
            self.add_module(f"conv{i}", Conv2d(cin, mid, 3, 1, 1))
            self.add_module(f"out{i}", ConvParam(mid, planes, 1, 1))

    def forward(self, x, stack: int):
        x = F.relu(getattr(self, f"conv{stack}")(x))
        out = getattr(self, f"out{stack}")
        y = conv2d(x, out.weight, out.bias, fp8=out.fp8)
        return y.permute(0, 2, 3, 1)


class CenterNetWHHead(nn.Module):
    """Shared 3x3 conv + ReLU, a (k,1) conv for H and a (1,k) conv for
    W; NHWC out, W then H."""

    def __init__(self, widths: Sequence[int], kernel: int = 17,
                 mid: int = 256):
        super().__init__()
        self.pad = (kernel - 1) // 2
        for i, cin in enumerate(widths):
            self.add_module(f"conv{i}", Conv2d(cin, mid, 3, 1, 1))
            self.add_module(f"hconv{i}", ConvParam(mid, 1, kernel, 1))
            self.add_module(f"wconv{i}", ConvParam(mid, 1, 1, kernel))

    def forward(self, x, stack: int):
        c = F.relu(getattr(self, f"conv{stack}")(x))
        hp = getattr(self, f"hconv{stack}")
        wp = getattr(self, f"wconv{stack}")
        h = conv2d(c, hp.weight, hp.bias, padding=(self.pad, 0), fp8=hp.fp8)
        w = conv2d(c, wp.weight, wp.bias, padding=(0, self.pad), fp8=wp.fp8)
        return torch.cat([w, h], dim=1).permute(0, 2, 3, 1)


class FasterRCNNHead(nn.Module):
    def __init__(self, in_channels: int):
        super().__init__()
        self.top = Bottleneck(in_channels, 64)
        self.regressor = Linear(256, 4)

    def forward(self, roi_feat):
        return self.regressor(self.top(roi_feat).mean(dim=(-2, -1)))


# ----------------------------------------------------------------- RRNet

class Outputs(NamedTuple):
    hms: tuple
    whs: tuple
    offsets: tuple
    stage2_reg: torch.Tensor
    rois: torch.Tensor
    roi_scores: torch.Tensor
    roi_classes: torch.Tensor
    roi_valid: torch.Tensor
    candidates: ops.Detections


def build_backbone(name: str, num_stacks: int):
    if name == "hourglass":
        return HourglassNet(num_stacks)
    if name == "tiny_hourglass":
        return HourglassNet(num_stacks, depth=2, inplanes=(64, 64, 96),
                            layer_nums=(1, 1, 1), num_feats=64)
    if name == "hrnetv2":
        return HRNetV2()
    raise ValueError(f"the reference has no backbone {name!r}")


class RRNet(nn.Module):
    """Stage 1: CenterNet heads on each stack's map (ReLU first, the
    attention added where configured); the last stack decoded to its
    top-k, hard-NMS'd per class, cut to the R best. Stage 2: 3x3
    ROI-align on relu(the last map) and the bottleneck regressor."""

    def __init__(self, num_classes: int = 10, num_stacks: int = 2,
                 backbone: str = "hourglass", wh_kernel: int = 17,
                 topk: int = 1500, stage2_rois: int = 512,
                 nms_iou: float = 0.7, nms_per_class: bool = True,
                 with_attention: bool = False):
        super().__init__()
        self.num_stacks, self.topk = num_stacks, topk
        self.stage2_rois, self.nms_iou = stage2_rois, nms_iou
        self.nms_per_class = nms_per_class
        self.with_attention = with_attention
        self.backbone = build_backbone(backbone, num_stacks)
        widths = self.backbone.out_channels[:num_stacks]
        if with_attention:
            for i, c in enumerate(widths):
                self.add_module(f"attention{i}", SelfAttentionModule(c))
        self.hm = CenterNetHead(num_classes, widths)
        self.wh = CenterNetWHHead(widths, wh_kernel)
        self.offset = CenterNetHead(2, widths)
        self.head_detector = FasterRCNNHead(self.backbone.out_channels[-1])

    def stage1(self, x):
        """Backbone, attention and heads: (feats, hms, whs, offsets)."""
        feats = self.backbone(x)
        hms, whs, offs = [], [], []
        for i in range(self.num_stacks):
            f = F.relu(feats[i])
            if self.with_attention:
                f = f + getattr(self, f"attention{i}")(f)
            hms.append(self.hm(f, i))
            whs.append(self.wh(f, i))
            offs.append(self.offset(f, i))
        return feats, hms, whs, offs

    def select_rois(self, boxes, scores, classes):
        cls_ids = classes if self.nms_per_class else None
        keep = ops.hard_nms(boxes.detach(), scores.detach(), self.nms_iou,
                            class_ids=cls_ids)
        masked = torch.where(keep, scores.detach(), -torch.inf)
        top, idx = ops.topk_desc(masked, self.stage2_rois)
        valid = top > -torch.inf
        rois = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        return (rois, torch.where(valid, top, 0.0),
                torch.gather(classes, 1, idx), valid)

    def forward(self, x, valid_hw: Optional[torch.Tensor] = None) -> Outputs:
        feats, hms, whs, offs = self.stage1(x)
        hm_last = hms[-1]
        if valid_hw is not None:
            hm_last = ops.mask_heatmap_extent(hm_last, valid_hw, 4)
        dets = ops.topk_decode(hm_last, whs[-1], offs[-1], k=self.topk)
        rois, roi_scores, roi_classes, roi_valid = self.select_rois(
            dets.boxes, dets.scores, dets.classes)
        last = F.relu(feats[-1]).permute(0, 2, 3, 1).contiguous()
        roi_feat = ops.roi_align(last, rois, (3, 3))     # (B, R, 3, 3, C)
        b, r, _, _, c = roi_feat.shape
        s2 = self.head_detector(
            roi_feat.reshape(b * r, 3, 3, c).permute(0, 3, 1, 2))
        return Outputs(tuple(hms), tuple(whs), tuple(offs),
                       s2.reshape(b, r, 4), rois, roi_scores, roi_classes,
                       roi_valid, dets)


def build_rrnet(arch: dict) -> RRNet:
    """The reference RRNet of a configuration file's `arch` section."""
    return RRNet(num_classes=arch["num_classes"],
                 num_stacks=arch["num_stacks"], backbone=arch["backbone"],
                 wh_kernel=arch["wh_kernel"], topk=arch["topk"],
                 stage2_rois=arch["stage2_rois"], nms_iou=arch["nms_iou"],
                 nms_per_class=arch["nms_per_class"],
                 with_attention=arch["with_attention"])
