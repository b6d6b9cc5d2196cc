"""State dicts in the layout of the reference PyTorch code (its module
names and OIHW shapes), made from a numpy seed for the converter tests.

`RefDict(small=True)` keeps every array's rank but cuts each dimension
to at most 2: enough to check the key mapping against the JAX
converters. `small=False` gives the real shapes, which the port's models
must load strictly. Each builder writes the keys the reference model
would have, `num_batches_tracked` included, and the heads the
converters leave out (ResNet's `fc`, ShuffleNet's `classifier`).
"""

import numpy as np


class RefDict:
    def __init__(self, seed: int = 0, small: bool = False):
        self.rng = np.random.default_rng(seed)
        self.small = small
        self.sd = {}

    def _shape(self, shape):
        return tuple(min(d, 2) for d in shape) if self.small else shape

    def _normal(self, shape, scale):
        return (self.rng.standard_normal(self._shape(shape), np.float32)
                * np.float32(scale))

    def conv(self, name, o, i, kh, kw=None, bias=False):
        self.sd[name + ".weight"] = self._normal((o, i, kh, kw or kh), 0.05)
        if bias:
            self.sd[name + ".bias"] = self._normal((o,), 0.1)

    def bn(self, name, c):
        self.sd[name + ".weight"] = np.abs(self._normal((c,), 1.0)) + 0.5
        self.sd[name + ".bias"] = self._normal((c,), 0.1)
        self.sd[name + ".running_mean"] = self._normal((c,), 0.1)
        self.sd[name + ".running_var"] = np.abs(self._normal((c,), 1.0)) + 0.5
        self.sd[name + ".num_batches_tracked"] = np.asarray(7, np.int64)

    def linear(self, name, o, i):
        self.sd[name + ".weight"] = self._normal((o, i), 0.05)
        self.sd[name + ".bias"] = self._normal((o,), 0.1)


def resnet(r: RefDict, layers=(3, 4, 6, 3)):
    """torchvision's ResNet with bottlenecks (ResNet-50 at the default)."""
    r.conv("conv1", 64, 3, 7)
    r.bn("bn1", 64)
    cin = 64
    for stage, blocks in enumerate(layers):
        planes = 64 * 2 ** stage
        for b in range(blocks):
            base = f"layer{stage + 1}.{b}"
            r.conv(base + ".conv1", planes, cin, 1)
            r.bn(base + ".bn1", planes)
            r.conv(base + ".conv2", planes, planes, 3)
            r.bn(base + ".bn2", planes)
            r.conv(base + ".conv3", planes * 4, planes, 1)
            r.bn(base + ".bn3", planes * 4)
            if b == 0:
                r.conv(base + ".downsample.0", planes * 4, cin, 1)
                r.bn(base + ".downsample.1", planes * 4)
            cin = planes * 4
    r.linear("fc", 1000, 2048)
    return r.sd


def _residual(r, name, cin, cout, stride=1):
    """The reference hourglass.py residual: conv1/bn1/conv2/bn2 and a
    skip_connection (1x1 conv, BN) when the shape changes."""
    r.conv(name + ".conv1", cout, cin, 3)
    r.bn(name + ".bn1", cout)
    r.conv(name + ".conv2", cout, cout, 3)
    r.bn(name + ".bn2", cout)
    if stride != 1 or cin != cout:
        r.conv(name + ".skip_connection.0", cout, cin, 1)
        r.bn(name + ".skip_connection.1", cout)


def _hourglass(r, name, n, inplanes, layer_nums, cin):
    cur, nxt = inplanes[0], inplanes[1]
    cur_num, nxt_num = layer_nums[0], layer_nums[1]
    for i in range(cur_num):
        _residual(r, f"{name}.up1.{i}", cin if i == 0 else cur, cur)
    _residual(r, f"{name}.low1.0", cin, nxt, stride=2)
    for i in range(1, cur_num):
        _residual(r, f"{name}.low1.{i}", nxt, nxt)
    if n > 1:
        _hourglass(r, f"{name}.low2", n - 1, inplanes[1:], layer_nums[1:],
                   nxt)
    else:
        for i in range(nxt_num):
            _residual(r, f"{name}.low2.{i}", nxt, nxt)
    for i in range(cur_num - 1):
        _residual(r, f"{name}.low3.{i}", nxt, nxt)
    _residual(r, f"{name}.low3.{cur_num - 1}", nxt, cur)


def hourglass(r: RefDict, num_stacks=2, depth=5,
              inplanes=(256, 256, 384, 384, 384, 512),
              layer_nums=(2, 2, 2, 2, 2, 4), num_feats=256, prefix=""):
    """The reference stacked hourglass (hourglass-104 at the defaults)."""
    p = prefix
    r.conv(p + "pre_layer.0", 128, 3, 7)
    r.bn(p + "pre_layer.1", 128)
    _residual(r, p + "pre_layer.3", 128, 256, stride=2)
    c0, cin = inplanes[0], 256
    for i in range(num_stacks):
        _hourglass(r, f"{p}hgs.{i}", depth, inplanes, layer_nums, cin)
        r.conv(f"{p}convs.{i}.conv", num_feats, c0, 3)
        r.bn(f"{p}convs.{i}.bn", num_feats)
        if i < num_stacks - 1:
            r.conv(f"{p}inter_.{i}.0", c0, cin, 1)
            r.bn(f"{p}inter_.{i}.1", c0)
            r.conv(f"{p}conv_.{i}.0", c0, num_feats, 1)
            r.bn(f"{p}conv_.{i}.1", c0)
            _residual(r, f"{p}residual.{i}", c0, c0)
            cin = c0
    return r.sd


def hrnet(r: RefDict, base=32, stage_modules=(1, 4, 3), multi_scale=False):
    """The reference HRNet (pose HRNet-w32 at the defaults: the last
    module keeps branch 0 only; `multi_scale=True` with base 40 is
    HRNetV2-w40, whose last module keeps all four)."""
    w = [base * 2 ** i for i in range(4)]
    r.conv("conv1", 64, 3, 3)
    r.bn("bn1", 64)
    r.conv("conv2", 64, 64, 3)
    r.bn("bn2", 64)
    for b in range(4):
        base_ = f"layer1.{b}"
        cin = 64 if b == 0 else 256
        r.conv(base_ + ".conv1", 64, cin, 1)
        r.bn(base_ + ".bn1", 64)
        r.conv(base_ + ".conv2", 64, 64, 3)
        r.bn(base_ + ".bn2", 64)
        r.conv(base_ + ".conv3", 256, 64, 1)
        r.bn(base_ + ".bn3", 256)
        if b == 0:
            r.conv(base_ + ".downsample.0", 256, 64, 1)
            r.bn(base_ + ".downsample.1", 256)
    r.conv("transition1.0.0", w[0], 256, 3)
    r.bn("transition1.0.1", w[0])
    r.conv("transition1.1.0.0", w[1], 256, 3)
    r.bn("transition1.1.0.1", w[1])
    for s_idx, n_modules in enumerate(stage_modules):
        stage = s_idx + 2
        if stage > 2:
            t = f"transition{stage - 1}.{stage - 1}.0"
            r.conv(t + ".0", w[stage - 1], w[stage - 2], 3)
            r.bn(t + ".1", w[stage - 1])
        for m in range(n_modules):
            base_ = f"stage{stage}.{m}"
            for j in range(stage):
                for b in range(4):
                    bb = f"{base_}.branches.{j}.{b}"
                    r.conv(bb + ".conv1", w[j], w[j], 3)
                    r.bn(bb + ".bn1", w[j])
                    r.conv(bb + ".conv2", w[j], w[j], 3)
                    r.bn(bb + ".bn2", w[j])
            last = stage == 4 and m == n_modules - 1
            outs = 1 if last and not multi_scale else stage
            for i in range(outs):
                for j in range(stage):
                    fl = f"{base_}.fuse_layers.{i}.{j}"
                    if j > i:
                        r.conv(fl + ".0", w[i], w[j], 1)
                        r.bn(fl + ".1", w[i])
                    for k in range(i - j):
                        cout = w[i] if k == i - j - 1 else w[j]
                        r.conv(f"{fl}.{k}.0", cout, w[j], 3)
                        r.bn(f"{fl}.{k}.1", cout)
    r.conv("final_layer", 17, w[0], 1, bias=True)     # the pose head
    return r.sd


def shufflenet(r: RefDict, chans=(24, 48, 96, 192, 1024),
               repeats=(4, 8, 4)):
    """The reference ShuffleNetV2 (0.5x at the defaults)."""
    r.conv("conv1.0", chans[0], 3, 3)
    r.bn("conv1.1", chans[0])
    cin, idx = chans[0], 0
    for stage, n in enumerate(repeats):
        out = chans[stage + 1]
        half = out // 2
        for i in range(n):
            base = f"features.{idx}"
            idx += 1
            if i == 0:
                r.conv(base + ".banch1.0", cin, 1, 3)      # depthwise
                r.bn(base + ".banch1.1", cin)
                r.conv(base + ".banch1.2", half, cin, 1)
                r.bn(base + ".banch1.3", half)
            r.conv(base + ".banch2.0", half, cin if i == 0 else half, 1)
            r.bn(base + ".banch2.1", half)
            r.conv(base + ".banch2.3", half, 1, 3)          # depthwise
            r.bn(base + ".banch2.4", half)
            r.conv(base + ".banch2.5", half, half, 1)
            r.bn(base + ".banch2.6", half)
            cin = out
    r.conv("conv_last.0", chans[-1], cin, 1)
    r.bn("conv_last.1", chans[-1])
    r.linear("classifier", 1000, chans[-1])
    return r.sd


def detector(r: RefDict, model="centernet", num_stacks=2, num_classes=10,
             wh_kernel=17, **hourglass_kw):
    """A reference CenterNet or RRNet: `backbone.` hourglass, per-stack
    heads (BasicCov 3x3 with bias, then the 1x1 out conv), and RRNet's
    FasterRCNNDetector (a Bottleneck and a 1x1 conv regressor)."""
    hourglass(r, num_stacks=num_stacks, prefix="backbone.", **hourglass_kw)

    def head(name, planes):
        for i in range(num_stacks):
            r.conv(f"{name}.detect_layer.{i}.0.conv", 256, 256, 3, bias=True)
            r.conv(f"{name}.detect_layer.{i}.1", planes, 256, 1, bias=True)

    head("hm", num_classes)
    for i in range(num_stacks):
        r.conv(f"wh.detect_conv_layer.{i}.0.conv", 256, 256, 3, bias=True)
        r.conv(f"wh.detect_H_layer.{i}.0.conv", 1, 256, wh_kernel, 1,
               bias=True)
        r.conv(f"wh.detect_W_layer.{i}.0.conv", 1, 256, 1, wh_kernel,
               bias=True)
    if model == "rrnet":
        head("offset_reg", 2)
        t = "head_detector.top_layer"
        r.conv(t + ".conv1", 64, 256, 1)
        r.bn(t + ".bn1", 64)
        r.conv(t + ".conv2", 64, 64, 3)
        r.bn(t + ".bn2", 64)
        r.conv(t + ".conv3", 256, 64, 1)
        r.bn(t + ".bn3", 256)
        r.conv("head_detector.regressor", 4, 256, 1, bias=True)
    else:
        head("reg", 2)
    return r.sd
