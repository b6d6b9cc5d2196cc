"""The eval conv-BN fold of `rrnet_torch.models.layers.Conv2d`'s
`conv(x, bn)`, on the CPU.

Every module that runs a conv straight into its BN, folded (eval mode,
no gradient wanted, no quant context) against the same module's plain
`bn(conv(x))` (run with gradients on), in f32 within 1e-5 on random
parameters and BN statistics away from (0, 1); in bf16 the folded
result's widest gap to the f32 result at most 1.5x the plain bf16
path's. The cached fold follows its tensors: a state-dict load, an
in-place edit of a running statistic or of a flat tensor whose views are
the parameters, a dtype move, any other move or cast of the module
(even one that changes no tensor) and `drop_int8_weights` each make the
next forward fold again (`conv_bn.fold_builds`). Train mode, gradients,
HRNet's `norm_eval` while training and both quant modes run unfolded
(`conv_bn.unfolded`), bit-equal to the plain composition, gradients too.
Two eval forwards of a small RRNet on HRNetV2 with attention fold every
pair and build each fold once. The `cuda` cases move a model to the
card, and make a round trip to the CPU with an edit of a running
statistic in between.
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

from rrnet_torch import config as tcfg
from rrnet_torch.models import build_model
from rrnet_torch.models import layers
from rrnet_torch.models import rrnet as t_rrnet_mod
from rrnet_torch.models.backbones import get_backbone, hrnet
from rrnet_torch.models.backbones.hourglass import HGResidual
from rrnet_torch.models.backbones.hrnetv2 import HRNetV2
from rrnet_torch.models.backbones.resnet import resnet10
from rrnet_torch.models.backbones.trident import BottleneckV2
from rrnet_torch.models.modules import SelfAttentionModule
from rrnet_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401

SMALL_HRNET = dict(base_channels=8, stage_modules=(1, 1, 1))
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def randomize(m: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Weights drawn by `init_weights`, then every BN's affine and
    statistics (mean != 0, var != 1), every conv bias and every
    zero-initialised conv weight (the attention's `W`) drawn at random."""
    gen = torch.Generator().manual_seed(seed)
    layers.init_weights(m, gen)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, layers.BatchNorm):
                n = mod.weight.shape[0]
                mod.weight.copy_(0.5 + torch.rand(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.3 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + 1.5 * torch.rand(n,
                                                             generator=gen))
            elif isinstance(mod, layers.Conv2d):
                if mod.bias is not None:
                    mod.bias.copy_(0.1 * torch.randn(mod.bias.shape,
                                                     generator=gen))
                if mod.init == "zeros":
                    mod.weight.copy_(0.1 * torch.randn(mod.weight.shape,
                                                       generator=gen))
    return m.eval()


def flat(out) -> torch.Tensor:
    """Every tensor of a (nested) output, flattened into one f32 vector."""
    if isinstance(out, torch.Tensor):
        return out.detach().float().reshape(-1)
    return torch.cat([flat(o) for o in out])


def counted(fn):
    """(fn's result, the conv_bn.* counts it made) under tracing."""
    tracing.enable()
    tracing.clear()
    try:
        with tracing.span("test"):
            out = fn()
    finally:
        tracing.disable()
    total = {"conv_bn.folded": 0, "conv_bn.unfolded": 0,
             "conv_bn.fold_builds": 0}
    for rec in tracing.records():
        for k, v in rec["counts"].items():
            if k in total:
                total[k] += v
    tracing.clear()
    return out, total


def folded(m, x):
    with torch.no_grad():
        return m(x)


def plain(m, x):
    """The module's plain conv-then-BN output: a copy run with gradients
    on, so that no pair folds."""
    ref = copy.deepcopy(m)
    for p in ref.parameters():
        p.requires_grad_(True)
    with torch.enable_grad():
        out, n = counted(lambda: ref(x))
    assert n["conv_bn.folded"] == 0 and n["conv_bn.unfolded"] > 0
    return out


def n_bn(m) -> int:
    return sum(isinstance(mod, layers.BatchNorm) for mod in m.modules())


def x_of(seed, *shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


class ListIn(torch.nn.Module):
    """A module that takes a list of maps, called on one tensor split by
    channels."""

    def __init__(self, inner, channels):
        super().__init__()
        self.inner, self.channels = inner, channels

    def forward(self, x):
        xs, at = [], 0
        for i, c in enumerate(self.channels):
            # branch i at 1/2**i of the input's size
            xs.append(x[:, at:at + c, ::2 ** i, ::2 ** i])
            at += c
        return self.inner(xs)


# name -> (a function of the dtype making the module, input shape)
CASES = {
    "ConvBN": (lambda dt: layers.ConvBN(6, 8, 3, 2, dtype=dt),
               (2, 6, 13, 11)),
    "HGResidual": (lambda dt: HGResidual(6, 8, stride=2, dtype=dt),
                   (2, 6, 12, 10)),
    "Bottleneck": (lambda dt: layers.Bottleneck(8, 4, stride=2, dtype=dt),
                   (2, 8, 12, 10)),
    "hrnet.BasicBlock": (lambda dt: hrnet.BasicBlock(6, 8, stride=2,
                                                     dtype=dt),
                         (2, 6, 12, 10)),
    # HRNet's and ShuffleNet's conv-BN(-ReLU) are `ConvBN`s
    "hrnet.ConvBNRelu": (lambda dt: layers.ConvBN(6, 8, 3, 2, dtype=dt),
                         (2, 6, 12, 10)),
    "hrnet.StageModule.fuse": (
        lambda dt: ListIn(hrnet.StageModule((4, 8, 16), num_blocks=1,
                                            dtype=dt), (4, 8, 16)),
        (2, 28, 16, 16)),
    "hourglass.pre": (lambda dt: get_backbone("tiny_hourglass", 1,
                                              dtype=dt),
                      (1, 3, 32, 32)),
    "SelfAttention": (lambda dt: SelfAttentionModule(
        8, key_channels=8, value_channels=8, kernel_size=3, dilation=2,
        padding=2, dtype=dt), (2, 8, 12, 10)),
    "resnet.stem": (lambda dt: resnet10(dtype=dt), (1, 3, 32, 32)),
    "shufflenet.ConvBNRelu": (lambda dt: layers.ConvBN(
        8, 8, 3, 1, groups=8, dtype=dt), (2, 8, 12, 10)),
    "trident.BottleneckV2": (lambda dt: BottleneckV2(8, 16, 2,
                                                     downsample=True),
                             (2, 8, 12, 10)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_folded_equals_the_plain_composition_in_f32(name):
    build, shape = CASES[name]
    m = randomize(build(torch.float32), seed=1)
    x = x_of(2, *shape)
    got, n = counted(lambda: folded(m, x))
    # the trident block's bn1-bn3 come before their convs: one pair
    assert n["conv_bn.folded"] == (1 if name == "trident.BottleneckV2"
                                   else n_bn(m))
    assert n["conv_bn.unfolded"] == 0
    torch.testing.assert_close(flat(got), flat(plain(m, x)), **TOL)


@pytest.mark.parametrize("name", ["ConvBN", "HGResidual", "Bottleneck",
                                  "hrnet.BasicBlock", "SelfAttention"])
def test_bf16_fold_loses_no_precision(name):
    """The folded weight is rounded to bf16 once, as the plain weight is:
    its result is no further from f32 than the plain bf16 path's."""
    build, shape = CASES[name]
    m32 = randomize(build(torch.float32), seed=3)
    m16 = build(torch.bfloat16).eval()
    m16.load_state_dict(m32.state_dict())
    x = x_of(4, *shape)
    want = flat(folded(m32, x)).double()
    gap_fold = (flat(folded(m16, x)).double() - want).abs().max()
    gap_plain = (flat(plain(m16, x)).double() - want).abs().max()
    assert gap_plain > 0
    assert gap_fold <= 1.5 * gap_plain, (float(gap_fold), float(gap_plain))


def _load(m, x):
    other = randomize(copy.deepcopy(m), seed=9)
    m.load_state_dict(other.state_dict())
    return lambda: m(x)


def _running_var(m, x):
    with torch.no_grad():
        m.bn.running_var.mul_(1.7)
    return lambda: m(x)


def _flat(m, x):
    """The module's tensors as views of one flat tensor (the Trainer's
    layout), edited in place through the flat tensor."""
    named = {**dict(m.named_parameters()), **dict(m.named_buffers())}
    base = torch.cat([t.detach().reshape(-1) for t in named.values()])

    def views():
        out, at = {}, 0
        for k, t in named.items():
            out[k] = base[at:at + t.numel()].view(t.shape)
            at += t.numel()
        return out

    first = functional_call(m, views(), (x,))
    again, n = counted(lambda: functional_call(m, views(), (x,)))
    assert n["conv_bn.fold_builds"] == 0 and torch.equal(first, again)
    base.mul_(1.1)
    m.load_state_dict(views())      # for the plain reference
    return lambda: functional_call(m, views(), (x,))


def _to_float64(m, x):
    m.to(torch.float64)
    return lambda: m(x)


def _dropped(m, x):
    layers.drop_int8_weights(m)
    return lambda: m(x)


@pytest.mark.parametrize("change", [_load, _running_var, _flat, _to_float64,
                                    _dropped],
                         ids=["load_state_dict", "running_var_in_place",
                              "flat_tensor_in_place", "to_float64",
                              "drop_int8_weights"])
def test_the_cache_follows_the_weights(change):
    m = randomize(layers.ConvBN(6, 8, 3, 2), seed=5)
    x = x_of(6, 2, 6, 13, 11)
    with torch.no_grad():
        _, n1 = counted(lambda: m(x))
        before, n2 = counted(lambda: m(x))
        assert (n1["conv_bn.fold_builds"], n2["conv_bn.fold_builds"]) == (1,
                                                                          0)
        run = change(m, x)
        got, n3 = counted(run)
        _, n4 = counted(run)
    assert n3["conv_bn.fold_builds"] == 1 and n3["conv_bn.folded"] == 1
    assert n4["conv_bn.fold_builds"] == 0
    want = plain(m, x)
    torch.testing.assert_close(got, want, **TOL)
    if change not in (_dropped, _to_float64):
        assert not torch.allclose(got, before)


def test_a_lone_conv_caches_its_cast_weight():
    conv = randomize(layers.Conv2d(6, 8, 3, padding=1,
                                   dtype=torch.bfloat16), seed=7)
    x = x_of(8, 2, 6, 9, 9)
    with torch.no_grad():
        a = conv(x)
        w = conv._eval[1]
        b = conv(x)
        assert conv._eval[1] is w and w.dtype == torch.bfloat16
        conv.weight.mul_(2.0)
        c = conv(x)
    assert torch.equal(a, b) and conv._eval[1] is not w
    want = F.conv2d(x.bfloat16(), conv.weight.bfloat16(),
                    conv.bias.bfloat16(), padding=1)
    assert torch.equal(c, want)
    # in train mode the cast is made anew and the cache left alone
    kept = conv._eval
    conv.train()
    with torch.no_grad():
        conv.weight.mul_(0.5)
        d = conv(x)
    assert conv._eval is kept
    assert torch.equal(d, F.conv2d(x.bfloat16(), conv.weight.bfloat16(),
                                   conv.bias.bfloat16(), padding=1))


def test_inference_tensors_fold_on_every_call():
    """Parameters made inside inference mode keep no version counter: the
    fold is made on each call and kept nowhere."""
    with torch.inference_mode():
        m = randomize(layers.ConvBN(6, 8, 3, 2), seed=19)
        x = x_of(20, 2, 6, 13, 11)
        got, n = counted(lambda: m(x))
        want = F.relu(m.bn(m.conv(x)))
    assert m.conv.weight.is_inference() and m.conv._eval is None
    assert (n["conv_bn.folded"], n["conv_bn.fold_builds"]) == (1, 1)
    torch.testing.assert_close(got, want, **TOL)


def test_a_fold_cached_in_inference_mode_serves_an_input_gradient():
    """Frozen parameters with gradients on: the pair folds, from the fold
    an inference-mode forward cached, and the input's gradient is the
    plain composition's."""
    m = randomize(layers.ConvBN(6, 8, 3, 2), seed=21).requires_grad_(False)
    x = x_of(22, 2, 6, 13, 11)
    with torch.inference_mode():
        m(x)
    xg = x.clone().requires_grad_()
    y, n = counted(lambda: m(xg))
    assert (n["conv_bn.folded"], n["conv_bn.fold_builds"]) == (1, 0)
    y.square().sum().backward()
    xr = x.clone().requires_grad_()
    want = F.relu(m.bn(m.conv(xr)))
    want.square().sum().backward()
    torch.testing.assert_close(y, want, **TOL)
    torch.testing.assert_close(xg.grad, xr.grad, **TOL)


def _composition(m, x):
    """`ConvBN`'s forward as it ran before the fold: relu(bn(conv(x)))."""
    return F.relu(m.bn(m.conv(x)))


def _run_train(m, x):
    m.train()
    with torch.no_grad():
        return m(x), {}


def _run_grad(m, x):
    out = m(x)
    out.square().sum().backward()
    return out.detach(), {"bn.weight": m.bn.weight.grad,
                          "conv.weight": m.conv.weight.grad}


def _run_calibrate(m, x):
    layers.name_quant_convs(m)
    with torch.no_grad(), layers.quant_context("calibrate") as ctx:
        out = m(x)
    return out, {"absmax": ctx.stats["conv"]}


def _run_int8(m, x):
    layers.name_quant_convs(m)
    with torch.no_grad(), layers.quant_context("int8", {"conv": 2.5}):
        return m(x), {}


@pytest.mark.parametrize("run", [_run_train, _run_grad, _run_calibrate,
                                 _run_int8],
                         ids=["train_mode", "grad_enabled", "calibrate",
                              "int8"])
def test_the_fold_does_not_engage(run, monkeypatch):
    """Each runs `bn(conv(x))` as before: outputs, gradients, statistics
    and the running update bit-equal to the plain composition's."""
    m = randomize(layers.ConvBN(40, 8, 3, 1), seed=11)
    x = x_of(12, 2, 40, 9, 9)
    ref = copy.deepcopy(m)
    (got, extra), n = counted(lambda: run(m, x))
    assert (n["conv_bn.folded"], n["conv_bn.unfolded"]) == (0, 1)
    assert m.conv._eval is None
    monkeypatch.setattr(ref, "forward", lambda x: _composition(ref, x))
    want, want_extra = run(ref, x)
    assert torch.equal(got, want)
    for k, v in extra.items():
        assert torch.equal(v, want_extra[k]), k
    for (k, a), b in zip(m.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k


def test_norm_eval_while_training_runs_unfolded(monkeypatch):
    """HRNetV2's backbone stays in eval mode while its parent trains; its
    pairs run unfolded, and its output and gradients are the plain
    composition's."""
    tm = randomize(HRNetV2(**SMALL_HRNET), seed=13)
    parent = torch.nn.Sequential(tm).train()
    assert not any(mod.training for mod in tm.modules())
    x = x_of(14, 2, 3, 64, 64)

    def step(model):
        outs = model(x)
        sum(o.square().mean() for o in outs).backward()
        return flat(outs), {k: p.grad for k, p in model.named_parameters()}

    ref = copy.deepcopy(parent)
    (got, grads), n = counted(lambda: step(parent))
    assert n["conv_bn.folded"] == 0
    assert n["conv_bn.unfolded"] == n_bn(tm)
    # the plain composition, `relu(bn(conv(x)) + residual)`
    monkeypatch.setattr(layers.Conv2d, "eval_form", lambda self, bn=None:
                        False)
    want, want_grads = step(ref)
    assert torch.equal(got, want)
    assert grads.keys() == want_grads.keys()
    for k, g in grads.items():
        assert (g is None) == (want_grads[k] is None), k
        assert g is None or torch.equal(g, want_grads[k]), k


def test_counters_of_two_eval_forwards_of_rrnet_hrnetv2_attention(
        monkeypatch):
    """Every pair of the model (backbone, attention towers, stage 2's
    bottleneck) folds on both forwards; the folds are built on the first
    alone."""
    monkeypatch.setattr(t_rrnet_mod, "get_backbone",
                        lambda name, num_stacks=2, dtype=torch.float32:
                        HRNetV2(dtype=dtype, **SMALL_HRNET))
    cfg = tcfg.rrnet_hrnetv2_attention_config(**{
        "model.topk": 32, "model.stage2_rois": 8,
        "model.dtype": "float32"})
    model = randomize(build_model(cfg, device="cpu"), seed=15)
    pairs = n_bn(model)
    assert pairs > 0
    x = x_of(16, 1, 3, 64, 64)
    with torch.inference_mode():
        first, n1 = counted(lambda: model(x))
        second, n2 = counted(lambda: model(x))
    assert n1 == {"conv_bn.folded": pairs, "conv_bn.unfolded": 0,
                  "conv_bn.fold_builds": pairs}
    assert n2 == {"conv_bn.folded": pairs, "conv_bn.unfolded": 0,
                  "conv_bn.fold_builds": 0}
    assert torch.equal(first.hms[-1], second.hms[-1])


@pytest.mark.parametrize("move", ["float", "cpu", "to"])
def test_a_move_or_cast_builds_every_fold_again(move):
    """A move or cast of the module gives each buffer a new tensor whose
    version starts again at 0, at an address that may come back: it
    drops every cached fold, even where it changes no tensor."""
    m = randomize(HRNetV2(**SMALL_HRNET), seed=23)
    pairs = n_bn(m)
    x = x_of(24, 1, 3, 32, 32)
    with torch.no_grad():
        first, n1 = counted(lambda: m(x))
        {"float": m.float, "cpu": m.cpu,
         "to": lambda: m.to("cpu", torch.float32)}[move]()
        again, n2 = counted(lambda: m(x))
    assert n1["conv_bn.fold_builds"] == n2["conv_bn.fold_builds"] == pairs
    assert torch.equal(flat(first), flat(again))


@pytest.mark.cuda
def test_cuda_a_move_to_the_card_folds_again():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = randomize(layers.ConvBN(6, 8, 3, 2), seed=17)
    x = x_of(18, 2, 6, 13, 11)
    with torch.no_grad():
        m(x)
        m.to("cuda")
        got, n = counted(lambda: m(x.cuda()))
    assert n["conv_bn.fold_builds"] == 1
    torch.testing.assert_close(got, plain(m, x.cuda()), **TOL)


@pytest.mark.cuda
def test_cuda_a_round_trip_with_an_edited_statistic_folds_again():
    """To the card, a forward, back to the CPU, `running_var` edited in
    place, to the card again: the fold follows the edit, whatever
    addresses the allocator hands back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = randomize(layers.ConvBN(6, 8, 3, 2, with_relu=False), seed=25)
    x = x_of(26, 2, 6, 13, 11).cuda()
    with torch.no_grad():
        m.cuda()
        before = m(x)
        m.cpu()
        m.bn.running_var.mul_(1.7)
        m.cuda()
        got, n = counted(lambda: m(x))
    assert n["conv_bn.fold_builds"] == 1
    torch.testing.assert_close(got, plain(m, x), **TOL)
    assert not torch.allclose(got, before)
