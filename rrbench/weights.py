"""Seeded weights for a model's state dict, made on the device.

One uniform draw from a `torch.Generator` on the device covers every
tensor, cut into pieces and mapped onto each tensor's range:

  * a conv or dense weight: U(+-1/sqrt(fan_in)), torch's default;
  * a batch norm's scale U(0.9, 1.1), shift U(-0.05, 0.05), running
    mean U(-0.05, 0.05) and running variance U(0.9, 1.1); the scale of
    the batch norm that ends a residual branch (a block's `bn2`, a
    bottleneck's `bn3`) from the configuration's `branch_end_scale`;
  * a bias: U(-0.05, 0.05); the heatmap heads' output bias is -2.19.

With branch ends near 1, a hundred residual blocks of random weights
are chaotic: bfloat16's rounding moves the heatmaps by half their spread
at full size, as much as float8's, and no comparison could tell the two
apart. Trained residual networks end their branches with small scales
(the residual branch adds a correction to the skip), and at 0.08-0.12
bfloat16 moves the maps by some 7% of their spread and float8 by 50%.

Drawn so, a deep network's activations shrink layer by layer, every
heatmap score is near sigmoid(-2.19) and every box near zero size: the
candidates tie, and no comparison could tell a right answer from a wrong
one. `calibrate` then gives the weights a trained detector's statistics,
on the reference and a frame from the seed: each batch norm's running
statistics become its input's statistics on that frame (the
normalisation a trained network has), and each head's output channels
are scaled and shifted onto the targets of the configuration file's
`weights` entry (heatmap logits, box sizes and offsets in feature
pixels, stage-2 deltas). The same seed gives the same tensors on the
same device, and the benchmark hands these same tensors to the port and
to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

from rrbench.reference.layers import BatchNorm, f32_numerics


def _branch_end(owner: str, shapes) -> bool:
    """Whether the batch norm `owner` ends a residual branch: a
    bottleneck's `bn3`, or the `bn2` of a block with no third conv."""
    block, _, bn = owner.rpartition(".")
    return bn == "bn3" or (bn == "bn2"
                           and f"{block}.conv3.weight" not in shapes)


def _ranges(shapes: Dict[str, Tuple[int, ...]],
            branch_end: Tuple[float, float]):
    """(name, lo, hi) of each tensor's uniform range."""
    bn = {k[:-len(".running_mean")] for k in shapes
          if k.endswith(".running_mean")}
    for name, shape in shapes.items():
        owner, _, leaf = name.rpartition(".")
        if len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            b = 1.0 / math.sqrt(fan_in)
            yield name, -b, b
        elif owner in bn and leaf == "weight" and _branch_end(owner, shapes):
            yield name, *branch_end
        elif owner in bn:
            lo, hi = {"weight": (0.9, 1.1), "bias": (-0.05, 0.05),
                      "running_mean": (-0.05, 0.05),
                      "running_var": (0.9, 1.1)}[leaf]
            yield name, lo, hi
        elif owner.startswith("hm.out") and leaf == "bias":
            yield name, -2.19, -2.19
        else:
            yield name, -0.05, 0.05


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device, branch_end: Tuple[float, float] = (0.9, 1.1)
                 ) -> Dict[str, torch.Tensor]:
    """float32 tensors for every (name, shape), drawn from `seed`;
    `branch_end` is the range of the scale of the batch norm that ends a
    residual branch."""
    shapes = {k: tuple(s) for k, s in shapes}
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, lo, hi in _ranges(shapes, branch_end):
        n = math.prod(shapes[name])
        out[name] = u[at:at + n].view(shapes[name]).mul(hi - lo).add_(lo)
        at += n
    return out


def shapes_of(module: torch.nn.Module):
    """(name, shape) of every parameter and buffer, as the state dict
    orders them."""
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def _fit(weight, bias, out, mean: float, std: float, dims) -> None:
    """Scale and shift the output channels of a layer (weight's dim 0,
    bias) whose output `out` has the channels on its dim 1 after
    reducing `dims`, onto `mean` and `std`."""
    m = out.mean(dims)
    sd = out.std(dims).clamp(min=1e-12)
    k = std / sd
    weight.mul_(k.view(-1, *([1] * (weight.dim() - 1))))
    bias.copy_(mean - (m - bias) * k)


def _bn_pass(bns, run) -> None:
    """Run `run()` with the batch norms `bns` normalising by their batch
    statistics, and keep those as their running statistics."""
    seen = {}

    def grab(mod, args):
        a = args[0].float()
        seen[mod] = (a.mean((0, 2, 3)), a.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(grab) for m in bns]
    for m in bns:
        m.training = True
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
        for m in bns:
            m.training = False
    for m in bns:
        mean, var = seen[m]
        m.running_mean.copy_(mean)
        # a channel all but dead on this frame would scale another
        # frame's values by up to 1/sqrt(eps): floor it
        m.running_var.copy_(var.clamp(min=0.1 * float(var.median())))


@torch.no_grad()
def calibrate(model, x: torch.Tensor, targets: dict) -> None:
    """Give the reference `model` a trained detector's statistics on the
    input `x` (module docstring), in place."""
    def bns(mod):
        return [m for m in mod.modules() if isinstance(m, BatchNorm)]

    with f32_numerics():
        stage2 = bns(model.head_detector)
        _bn_pass([m for m in bns(model) if m not in stage2],
                 lambda: model.stage1(x))
        _, hms, whs, offs = model.stage1(x)
        for i, (hm, wh, off) in enumerate(zip(hms, whs, offs)):
            o = getattr(model.hm, f"out{i}")
            _fit(o.weight, o.bias, hm.permute(0, 3, 1, 2),
                 *targets["heatmap_logit"], (0, 2, 3))
            for c, name in ((0, "wconv"), (1, "hconv")):
                o = getattr(model.wh, f"{name}{i}")
                _fit(o.weight, o.bias, wh[..., c:c + 1].permute(0, 3, 1, 2),
                     *targets["wh"], (0, 2, 3))
            o = getattr(model.offset, f"out{i}")
            _fit(o.weight, o.bias, off.permute(0, 3, 1, 2),
                 *targets["offset"], (0, 2, 3))
        _bn_pass(stage2, lambda: model(x))
        reg = model.head_detector.regressor
        _fit(reg.weight, reg.bias, model(x).stage2_reg.reshape(-1, 4),
             *targets["stage2_delta"], (0,))
