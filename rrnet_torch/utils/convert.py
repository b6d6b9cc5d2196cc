"""Dataset and checkpoint converters (port of `rrnet_tpu/utils/convert.py`).

  * VisDrone -> COCO JSON (reference utils/data_type_convertor.py:7-153;
    all 12 categories, ignored regions (0) and others (11) included).
  * A checkpoint of the reference PyTorch code (ResNet, hourglass, HRNet
    and ShuffleNet backbones; whole CenterNet and RRNet detectors) ->
    the port's `state_dict`, with the JAX converters' report of the keys
    left over (`{"unexpected": [...]}`).

The reference and the port both store convolutions OIHW, so a converter
is a table of entries, a reference key beside the port's key. Only two
kinds of entry change shape: RRNet's stage-2 `regressor`, a (4, 256, 1,
1) conv in the reference and a (4, 256) `Linear` in the port, and none
else; the depthwise ShuffleNet kernels are (C, 1, kh, kw) in both. The
tables are built by walking the architecture, as the JAX converters do,
with a probe `has(reference key, port key)` where the JAX converter
looks a key up: `convert_*` probe the reference dict and map it to the
port; `reference_state_dict` probes the port's dict and maps it back.

Every `convert_*` returns `(state_dict, report)`: f32 CPU tensors under
the port's module names, and the reference keys that no entry took
(without `num_batches_tracked`, and without the heads the JAX converter
drops: ResNet's `fc.`, HRNet's `final_layer.`, ShuffleNet's
`classifier.`). `convert_detector_params`, as the JAX one, counts every
`backbone.` key as taken. A key an entry needs and the dict lacks raises
KeyError, where the JAX converter raises it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from rrnet_torch.data.visdrone import VISDRONE_CLASS_NAMES

Probe = Callable[[str, str], bool]
_BN = (".weight", ".bias", ".running_mean", ".running_var")


# ---------------------------------------------------------------------------
# VisDrone -> COCO
# ---------------------------------------------------------------------------

def visdrone_to_coco(root_dir: str, split: str, out_path: str) -> str:
    """Write a COCO-format JSON of a VisDrone split (the reference's
    semantics: every category, bbox xywh, iscrowd 0, area w*h, the score
    column kept). Returns `out_path`."""
    from PIL import Image

    images_dir = os.path.join(root_dir, split, "images")
    annos_dir = os.path.join(root_dir, split, "annotations")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(images_dir)
                   if f.endswith(".jpg"))
    categories = [{"id": i, "name": n, "supercategory": "none"}
                  for i, n in enumerate(VISDRONE_CLASS_NAMES)]
    images, annotations = [], []
    for img_id, name in enumerate(names, start=1):
        with Image.open(os.path.join(images_dir, name + ".jpg")) as im:
            w, h = im.size
        images.append({"id": img_id, "file_name": name + ".jpg",
                       "width": w, "height": h})
        path = os.path.join(annos_dir, name + ".txt")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                line = line.strip().strip(",")
                if not line:
                    continue
                vals = [float(v) for v in line.split(",")[:8]]
                annotations.append({
                    "id": len(annotations) + 1, "image_id": img_id,
                    "category_id": int(vals[5]), "bbox": vals[:4],
                    "area": vals[2] * vals[3], "iscrowd": 0,
                    "score": vals[4]})
    with open(out_path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    return out_path


# ---------------------------------------------------------------------------
# reference checkpoints -> the port's state_dict
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` as {key: CPU tensor}: a `model`- or
    `state_dict`-wrapped dict is unwrapped and `module.` prefixes (the
    reference's DataParallel) are stripped (reference backbones/load.py)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k:
            torch.as_tensor(v) for k, v in sd.items()}


class Entry(NamedTuple):
    ref: str               # the reference checkpoint's key
    port: str              # the port's state_dict key
    linear: bool = False   # (O, I, 1, 1) in the reference, (O, I) here


class Table:
    """Entries under a reference prefix and a port prefix; `has(ref,
    port)` answers the converters' key probes (module docstring)."""

    def __init__(self, has: Probe, entries: Optional[List[Entry]] = None,
                 ref_pre: str = "", port_pre: str = ""):
        self._has = has
        self.entries = [] if entries is None else entries
        self.ref_pre, self.port_pre = ref_pre, port_pre

    def scoped(self, ref: str, port: str) -> "Table":
        return Table(self._has, self.entries, self.ref_pre + ref + ".",
                     self.port_pre + port + ".")

    def has(self, ref: str, port: str) -> bool:
        return self._has(self.ref_pre + ref, self.port_pre + port)

    def add(self, ref: str, port: str, linear: bool = False) -> None:
        self.entries.append(Entry(self.ref_pre + ref, self.port_pre + port,
                                  linear))

    def conv(self, ref: str, port: str, bias: bool = True) -> None:
        """A conv's weight, and its bias where the probe finds one."""
        self.add(ref + ".weight", port + ".weight")
        if bias and self.has(ref + ".bias", port + ".bias"):
            self.add(ref + ".bias", port + ".bias")

    def bn(self, ref: str, port: str) -> None:
        for suf in _BN:
            self.add(ref + suf, port + suf)

    def conv_bn(self, port: str, conv_ref: str, bn_ref: str) -> None:
        """A `ConvBN`-like module: `{port}.conv` and `{port}.bn`."""
        self.conv(conv_ref, port + ".conv")
        self.bn(bn_ref, port + ".bn")

    def block(self, ref: str, port: str, n: int, bias: bool = True) -> None:
        """conv1..conv{n} and bn1..bn{n} of a residual block."""
        for i in range(1, n + 1):
            self.conv(f"{ref}.conv{i}", f"{port}.conv{i}", bias)
            self.bn(f"{ref}.bn{i}", f"{port}.bn{i}")


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(
        v.detach().cpu() if isinstance(v, torch.Tensor) else v,
        dtype=np.float32, order="C"))


def _apply(entries: List[Entry], state_dict: Mapping, skip: Callable
           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    out = {}
    for e in entries:
        v = _f32(state_dict[e.ref])
        out[e.port] = v.reshape(v.shape[:2]) if e.linear else v
    used = {e.ref for e in entries}
    unexpected = sorted(k for k in state_dict if k not in used
                        and "num_batches_tracked" not in k and not skip(k))
    return out, {"unexpected": unexpected}


def reference_state_dict(build: Callable[[Table], None],
                         state_dict: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The reference checkpoint layout of a port `state_dict`: the table
    that `build` makes, probed on the port's keys, read backwards."""
    t = Table(lambda ref, port: port in state_dict)
    build(t)
    out = {}
    for e in t.entries:
        v = state_dict[e.port].detach().cpu()
        out[e.ref] = v.reshape(*v.shape, 1, 1) if e.linear else v
    return out


def resnet_table(t: Table, layers: Tuple[int, ...] = (3, 4, 6, 3)) -> None:
    """torchvision's ResNet keys -> `backbones.resnet.ResNet` (JAX
    convert.py:110-186; convs without bias, absent blocks skipped)."""
    def conv_bn(ref_c, ref_b, port_c, port_b):
        if t.has(ref_c + ".weight", port_c + ".weight"):
            t.conv(ref_c, port_c, bias=False)
        if t.has(ref_b + ".weight", port_b + ".weight"):
            t.bn(ref_b, port_b)

    conv_bn("conv1", "bn1", "conv1", "bn1")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            ref, port = f"layer{stage + 1}.{b}", f"layer{stage + 1}_{b}"
            for ci in (1, 2, 3):
                conv_bn(f"{ref}.conv{ci}", f"{ref}.bn{ci}",
                        f"{port}.conv{ci}", f"{port}.bn{ci}")
            if t.has(f"{ref}.downsample.0.weight",
                     f"{port}.downsample_conv.weight"):
                t.conv(f"{ref}.downsample.0", f"{port}.downsample_conv",
                       bias=False)
                t.bn(f"{ref}.downsample.1", f"{port}.downsample_bn")


def hourglass_table(t: Table, num_stacks: int = 2, depth: int = 5) -> None:
    """The reference stacked hourglass (pre_layer, hgs.N's recursive
    up1/low1/low2/low3, convs.N, inter_.N, conv_.N, residual.N) ->
    `backbones.hourglass.HourglassNet` (JAX convert.py:189-285)."""
    def residual(ref, port):
        t.block(ref, port, 2)
        if t.has(f"{ref}.skip_connection.0.weight",
                 f"{port}.skip_conv.weight"):
            t.conv(f"{ref}.skip_connection.0", f"{port}.skip_conv")
            t.bn(f"{ref}.skip_connection.1", f"{port}.skip_bn")

    def seq(ref, port):
        n = 0
        while t.has(f"{ref}.{n}.conv1.weight", f"{port}_{n}.conv1.weight"):
            residual(f"{ref}.{n}", f"{port}_{n}")
            n += 1

    def hourglass(ref, port, level):
        for branch in ("up1", "low1", "low3"):
            seq(f"{ref}.{branch}", f"{port}.{branch}")
        if level > 1:
            hourglass(f"{ref}.low2", f"{port}.low2", level - 1)
        else:
            seq(f"{ref}.low2", f"{port}.low2")

    t.conv("pre_layer.0", "pre_conv")
    t.bn("pre_layer.1", "pre_bn")
    residual("pre_layer.3", "pre_res")
    for i in range(num_stacks):
        hourglass(f"hgs.{i}", f"hg{i}", depth)
        t.conv_bn(f"out_conv{i}", f"convs.{i}.conv", f"convs.{i}.bn")
        if i < num_stacks - 1:
            t.conv_bn(f"inter{i}", f"inter_.{i}.0", f"inter_.{i}.1")
            t.conv_bn(f"fuse{i}", f"conv_.{i}.0", f"conv_.{i}.1")
            residual(f"residual.{i}", f"inter_res{i}")


def hrnet_table(t: Table, stage_modules: Tuple[int, int, int] = (1, 4, 3)
                ) -> None:
    """The reference HRNet-w48/w32 and HRNetV2-w40 (one key scheme) ->
    `backbones.hrnet` (JAX convert.py:288-402)."""
    t.conv_bn("stem1", "conv1", "bn1")
    t.conv_bn("stem2", "conv2", "bn2")
    for b in range(4):
        ref, port = f"layer1.{b}", f"layer1_{b}"
        t.block(ref, port, 3)
        if t.has(f"{ref}.downsample.0.weight",
                 f"{port}.downsample_conv.weight"):
            t.conv(f"{ref}.downsample.0", f"{port}.downsample_conv")
            t.bn(f"{ref}.downsample.1", f"{port}.downsample_bn")
    # transition{n}.{i}: (conv, bn, relu) reshaping a branch, or
    # ((conv, bn, relu),) making a new, downsampled one
    t.conv_bn("trans1_0", "transition1.0.0", "transition1.0.1")
    t.conv_bn("trans1_1", "transition1.1.0.0", "transition1.1.0.1")
    t.conv_bn("trans2_2", "transition2.2.0.0", "transition2.2.0.1")
    t.conv_bn("trans3_3", "transition3.3.0.0", "transition3.3.0.1")
    for s_idx, n_modules in enumerate(stage_modules):
        stage = s_idx + 2
        for m in range(n_modules):
            s = t.scoped(f"stage{stage}.{m}", f"stage{stage}_{m}")
            for j in range(stage):
                for b in range(4):
                    s.block(f"branches.{j}.{b}", f"branch{j}_block{b}", 2)
            for i in range(stage):
                for j in range(stage):
                    fl = f"fuse_layers.{i}.{j}"
                    if i < j and s.has(fl + ".0.weight",
                                       f"fuse{i}_{j}_conv.weight"):
                        s.conv(fl + ".0", f"fuse{i}_{j}_conv")
                        s.bn(fl + ".1", f"fuse{i}_{j}_bn")
                    elif i > j:
                        for k in range(i - j):
                            if not s.has(f"{fl}.{k}.0.weight",
                                         f"fuse{i}_{j}_down{k}.conv.weight"):
                                break
                            s.conv_bn(f"fuse{i}_{j}_down{k}", f"{fl}.{k}.0",
                                      f"{fl}.{k}.1")


def shufflenet_table(t: Table, stage_repeats: Tuple[int, ...] = (4, 8, 4)
                     ) -> None:
    """The reference ShuffleNetV2 (conv1, features.N InvertedResidual
    with banch1/banch2, conv_last) -> `backbones.shufflenet` (JAX
    convert.py:405-475). Its depthwise kernels are (C, 1, kh, kw) in
    both layouts: the port's grouped conv takes them as they are."""
    t.conv_bn("conv1", "conv1.0", "conv1.1")
    idx = 0
    for stage, repeats in enumerate(stage_repeats):
        for i in range(repeats):
            ref, port = f"features.{idx}", f"stage{stage}_{i}"
            idx += 1
            if i == 0:      # the stride-2 unit: banch1 = dw, bn, pwl, bn
                t.conv_bn(f"{port}.b1_dw", f"{ref}.banch1.0",
                          f"{ref}.banch1.1")
                t.conv_bn(f"{port}.b1_pwl", f"{ref}.banch1.2",
                          f"{ref}.banch1.3")
            # banch2 = pw, bn, relu, dw, bn, pwl, bn, relu
            t.conv_bn(f"{port}.b2_pw", f"{ref}.banch2.0", f"{ref}.banch2.1")
            t.conv_bn(f"{port}.b2_dw", f"{ref}.banch2.3", f"{ref}.banch2.4")
            t.conv_bn(f"{port}.b2_pwl", f"{ref}.banch2.5", f"{ref}.banch2.6")
    t.conv_bn("conv_last", "conv_last.0", "conv_last.1")


def detector_table(t: Table, model: str = "centernet", num_stacks: int = 2,
                   depth: int = 5) -> None:
    """A reference CenterNet or RRNet (hourglass backbone, per-stack
    heads, RRNet's FasterRCNNDetector) -> the port's `CenterNet` /
    `RRNet` (JAX convert.py:478-557)."""
    hourglass_table(t.scoped("backbone", "backbone"), num_stacks, depth)

    def plain_head(ref, port):   # detect_layer.i: BasicCov 3x3, 1x1 out
        for i in range(num_stacks):
            t.conv(f"{ref}.detect_layer.{i}.0.conv", f"{port}.conv{i}")
            t.conv(f"{ref}.detect_layer.{i}.1", f"{port}.out{i}")

    plain_head("hm", "hm")
    for i in range(num_stacks):
        t.conv(f"wh.detect_conv_layer.{i}.0.conv", f"wh.conv{i}")
        t.conv(f"wh.detect_H_layer.{i}.0.conv", f"wh.hconv{i}")
        t.conv(f"wh.detect_W_layer.{i}.0.conv", f"wh.wconv{i}")
    if model == "rrnet":
        plain_head("offset_reg", "offset")
        t.block("head_detector.top_layer", "head_detector.top", 3)
        t.add("head_detector.regressor.weight",
              "head_detector.regressor.weight", linear=True)
        t.add("head_detector.regressor.bias", "head_detector.regressor.bias")
    else:
        plain_head("reg", "reg")


def _convert(build, state_dict, skip=lambda k: False):
    t = Table(lambda ref, port: ref in state_dict)
    build(t)
    return _apply(t.entries, state_dict, skip)


def convert_resnet_params(state_dict: Mapping,
                          layers: Tuple[int, ...] = (3, 4, 6, 3)):
    """torchvision-style ResNet -> (state_dict of `ResNet(layers)`,
    report); `fc.` keys are not reported."""
    return _convert(lambda t: resnet_table(t, layers), state_dict,
                    lambda k: "fc." in k)


def convert_hourglass_params(state_dict: Mapping, num_stacks: int = 2,
                             depth: int = 5):
    """Reference stacked hourglass -> (state_dict of `HourglassNet`,
    report)."""
    return _convert(lambda t: hourglass_table(t, num_stacks, depth),
                    state_dict)


def convert_hrnet_params(state_dict: Mapping,
                         stage_modules: Tuple[int, int, int] = (1, 4, 3)):
    """Reference HRNet / HRNetV2 -> (state_dict of the port's HRNet,
    report); the pose head's `final_layer.` keys are not reported."""
    return _convert(lambda t: hrnet_table(t, stage_modules), state_dict,
                    lambda k: k.startswith("final_layer."))


def convert_shufflenet_params(state_dict: Mapping,
                              stage_repeats: Tuple[int, ...] = (4, 8, 4)):
    """Reference ShuffleNetV2 -> (state_dict of `ShuffleNetV2`, report);
    the ImageNet `classifier.` keys are not reported."""
    return _convert(lambda t: shufflenet_table(t, stage_repeats),
                    state_dict, lambda k: k.startswith("classifier."))


def convert_detector_params(state_dict: Mapping, model: str = "centernet",
                            num_stacks: int = 2, depth: int = 5):
    """Reference CenterNet / RRNet checkpoint -> (state_dict of the
    port's `CenterNet` / `RRNet`, report); every `backbone.` key counts
    as taken, as in the JAX converter."""
    return _convert(lambda t: detector_table(t, model, num_stacks, depth),
                    state_dict, lambda k: k.startswith("backbone."))


def merge_pretrained(model: nn.Module, state_dict: Mapping,
                     scope: str = "backbone") -> nn.Module:
    """Graft converted weights into `model` in place: each entry whose
    shape equals the model's, as f32, under `scope` where the model has
    a child of that name, else at the top; the others are skipped (the
    reference's strict=False). Returns the model."""
    prefix = scope + "." if scope in dict(model.named_children()) else ""
    own = model.state_dict()
    with torch.no_grad():
        for k, v in state_dict.items():
            dst = own.get(prefix + k)
            if dst is not None and tuple(dst.shape) == tuple(np.shape(v)):
                dst.copy_(_f32(v))
    return model
