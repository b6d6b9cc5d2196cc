"""The eval convolution's epilogue: `ops.conv_epilogue` and its call sites.

On the CPU:
  (a) every block whose convs now take `residual=` and `relu=`
      (`ResidualBlock` with and without its skip conv, and with the SE
      scale; `Bottleneck`; HRNet's `BasicBlock`; `ConvBN`, also as HRNet's
      and ShuffleNet's conv-BN-ReLU; the three heads' towers; the
      attention's towers; the trident's stem) equals, bit for bit, its
      forward as written before, in
      eval mode in f32 and bf16, and in each mode where the kernel does
      not engage (train mode, a gradient wanted, calibration, int8);
  (b) the routing: every one of those runs moves `conv_epilogue.plain`
      and never `conv_epilogue.kernel`;
  (c) the plain version's arithmetic, and `fits`'s layouts.

The `cuda` cases run on the card, with

    python -m pytest --noconftest -m cuda tests/test_torch_conv_epilogue.py

and skip without a CUDA device: the kernel equals the plain chain bit
for bit in bf16 and f32 (C in {1, 3, 10, 40, 256, 384}, odd H and W; no
residual or a residual; a bf16 y with an f32 residual, as stage 2's;
ReLU on and off; NaN, +-inf and -0.0 among the inputs); cuDNN's biased
convolution, dense or depthwise, equals the unbiased one finished by the
kernel; it raises on an NCHW-strided input or residual and on other
dtypes and counts its launches; every call site of (a) equals its old
composition bit for bit on the card, each of its convs finished by the
kernel; and a small RRNet's eval forward (maps) and `Evaluator` rows
equal, bit for bit, the same model with every block composed the old
way, with every epilogue through the kernel. This module imports no
JAX.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rrnet_torch import config as tcfg
from rrnet_torch.models import build_model, layers
from rrnet_torch.models.backbones import hrnet
from rrnet_torch.models.backbones.hourglass import HGResidual
from rrnet_torch.models.backbones.trident import TridentResNet
from rrnet_torch.models.heads import (CenterNetHead, CenterNetWHHead,
                                      RetinaNetHead)
from rrnet_torch.models.modules import SelfAttentionModule
from rrnet_torch.ops import conv_epilogue as ce
from rrnet_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401

CL = torch.channels_last


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def randomize(m: torch.nn.Module, seed: int) -> torch.nn.Module:
    """`init_weights`, then every BN's affine and statistics away from
    (1, 0, 0, 1) and every conv bias drawn; eval mode."""
    gen = torch.Generator().manual_seed(seed)
    layers.init_weights(m, gen)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, layers.BatchNorm):
                n = mod.weight.shape[0]
                mod.weight.copy_(0.5 + torch.rand(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.3 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))
            elif isinstance(mod, (layers.Conv2d, layers.Linear)):
                if mod.bias is not None:
                    mod.bias.copy_(0.1 * torch.randn(mod.bias.shape,
                                                     generator=gen))
                if mod.init == "zeros":
                    mod.weight.copy_(0.1 * torch.randn(mod.weight.shape,
                                                       generator=gen))
    return m.eval()


def counted(fn):
    """(fn's result, the conv_epilogue.* counts it made) under tracing."""
    tracing.enable()
    tracing.clear()
    try:
        with tracing.span("test"):
            out = fn()
    finally:
        tracing.disable()
    total = {"conv_epilogue.kernel": 0, "conv_epilogue.plain": 0}
    for rec in tracing.records():
        for k, v in rec["counts"].items():
            if k in total:
                total[k] += v
    tracing.clear()
    return out, total


# The forwards as they were written before the epilogue: each conv (with
# its BN) without `residual=` or `relu=`, the adds and ReLUs as ops.

def old_residual(m, x):
    out = F.relu(m.conv1(x, m.bn1))
    out = m.conv2(out, m.bn2)
    if m.se is not None:
        out = m.se(out)
    skip = x if m.skip_conv is None else m.skip_conv(x, m.skip_bn)
    return F.relu(out + skip)


def old_bottleneck(m, x):
    out = F.relu(m.conv1(x, m.bn1))
    out = F.relu(m.conv2(out, m.bn2))
    out = m.conv3(out, m.bn3)
    skip = (x if m.downsample_conv is None
            else m.downsample_conv(x, m.downsample_bn))
    return F.relu(out + skip)


def old_basic(m, x):
    out = F.relu(m.conv1(x, m.bn1))
    out = m.conv2(out, m.bn2)
    skip = x if m.down_conv is None else m.down_conv(x, m.down_bn)
    return F.relu(out + skip)


def old_convbn(m, x):
    x = m.conv(x, m.bn)
    return F.relu(x) if m.with_relu else x


def old_centernet_head(m, x):
    x = F.relu(m.conv0(x))
    w = m.out0.weight[:, :, 0, 0].to(m.dtype)
    return x.permute(0, 2, 3, 1) @ w.t() + m.out0.bias.to(m.dtype)


def old_wh_head(m, x):
    conv = F.relu(m.conv0(x))
    h = layers.conv2d(conv, m.hconv0.weight.to(m.dtype),
                      m.hconv0.bias.to(m.dtype), padding=(m.pad, 0))
    w = layers.conv2d(conv, m.wconv0.weight.to(m.dtype),
                      m.wconv0.bias.to(m.dtype), padding=(0, m.pad))
    out = torch.stack([w, h], dim=-1)
    bsz, p, hh, ww, _ = out.shape
    return out.permute(0, 2, 3, 1, 4).reshape(bsz, hh, ww, 2 * p)


def old_retina_head(m, x):
    for i in range(4):
        x = F.relu(getattr(m, f"conv{i}")(x))
    return m.out(x)


def old_tower(m, x):
    y = F.relu(m.f_key_conv1(x, m.f_key_bn1))
    return F.relu(m.f_key_conv2(y, m.f_key_bn2))


def new_tower(m, x):
    return m._tower(x, "f_key")


def old_trident_stem(m, x):
    return layers.max_pool(F.relu(m.conv1(x, m.bn1)), 3, 2, 1)


class _Stem(Exception):
    """Raised with `layer1_0`'s input, to stop the trident's forward there."""


def new_trident_stem(m, x):
    """`TridentResNet.forward` up to its first block: the stem's output."""
    def stop(mod, args):
        raise _Stem(args[0])

    hook = m.layer1_0.register_forward_pre_hook(stop)
    try:
        m(x)
    except _Stem as e:
        return e.args[0]
    finally:
        hook.remove()


# name -> (module of a dtype, input shape, old forward, new forward, the
# number of convs it finishes)
CASES = {
    "ResidualBlock": (lambda dt: layers.ResidualBlock(8, 8, dtype=dt),
                      (2, 8, 11, 9), old_residual, None, 2),
    "ResidualBlock.skip": (lambda dt: layers.ResidualBlock(
        6, 8, stride=2, dtype=dt), (2, 6, 11, 9), old_residual, None, 3),
    "HGResidual.se": (lambda dt: HGResidual(6, 16, se=True, dtype=dt),
                      (2, 6, 11, 9), old_residual, None, 3),
    "Bottleneck": (lambda dt: layers.Bottleneck(16, 4, dtype=dt),
                   (2, 16, 11, 9), old_bottleneck, None, 3),
    "Bottleneck.down": (lambda dt: layers.Bottleneck(8, 4, stride=2,
                                                     dtype=dt),
                        (2, 8, 11, 9), old_bottleneck, None, 4),
    "hrnet.BasicBlock": (lambda dt: hrnet.BasicBlock(8, 8, dtype=dt),
                         (2, 8, 11, 9), old_basic, None, 2),
    "hrnet.BasicBlock.down": (lambda dt: hrnet.BasicBlock(
        6, 8, stride=2, dtype=dt), (2, 6, 11, 9), old_basic, None, 3),
    "ConvBN": (lambda dt: layers.ConvBN(6, 8, 3, 2, dtype=dt),
               (2, 6, 11, 9), old_convbn, None, 1),
    "ConvBN.no_relu": (lambda dt: layers.ConvBN(6, 8, 1, with_relu=False,
                                                dtype=dt),
                       (2, 6, 11, 9), old_convbn, None, 1),
    "ConvBN.no_bn": (lambda dt: layers.ConvBN(6, 8, 3, with_bn=False,
                                              dtype=dt),
                     (2, 6, 11, 9), old_convbn, None, 1),
    # HRNet's and ShuffleNet's conv-BN(-ReLU) are `ConvBN`s
    "hrnet.ConvBNRelu": (lambda dt: layers.ConvBN(6, 8, 3, 2, dtype=dt),
                         (2, 6, 11, 9), old_convbn, None, 1),
    "shufflenet.ConvBNRelu": (lambda dt: layers.ConvBN(
        8, 8, 3, 1, groups=8, dtype=dt), (2, 8, 11, 9), old_convbn,
        None, 1),
    "CenterNetHead": (lambda dt: CenterNetHead(
        3, num_stacks=1, mid_channels=16, in_channels=8, dtype=dt),
        (2, 8, 11, 9), old_centernet_head, lambda m, x: m(x, 0), 1),
    "CenterNetWHHead": (lambda dt: CenterNetWHHead(
        1, num_stacks=1, kernel=5, mid_channels=16, in_channels=8,
        dtype=dt), (2, 8, 11, 9), old_wh_head, lambda m, x: m(x, 0), 1),
    "RetinaNetHead": (lambda dt: RetinaNetHead(
        5, in_channels=8, mid_channels=16, dtype=dt), (2, 8, 11, 9),
        old_retina_head, None, 5),
    "SelfAttention.tower": (lambda dt: SelfAttentionModule(
        8, key_channels=8, value_channels=8, kernel_size=3, padding=1,
        dtype=dt), (2, 8, 11, 9), old_tower, new_tower, 2),
    # f32 only: a bf16 input runs through its f32 convs
    "trident.stem": (lambda dt: TridentResNet(), (2, 3, 11, 9),
                     old_trident_stem, new_trident_stem, 1),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def inputs(shape, dtype, seed=5):
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(seed))
    return x.to(dtype).contiguous(memory_format=CL)


def run_new(name, m, x):
    new = CASES[name][3]
    return m(x) if new is None else new(m, x)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_new_call_sites_equal_the_old_composition(name, dt):
    """Eval mode, no gradients: bit-equal, every conv finished plain on
    the CPU."""
    build, shape, old, _, n_convs = CASES[name]
    m = randomize(build(DTYPES[dt]), seed=1)
    x = inputs(shape, DTYPES[dt])
    with torch.no_grad():
        got, n = counted(lambda: run_new(name, m, x))
        want = old(m, x)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert n == {"conv_epilogue.kernel": 0, "conv_epilogue.plain": n_convs}


def _train(m, x, fn):
    m.train()
    with torch.no_grad():
        return fn(m, x), {}


def _grad(m, x, fn):
    out = fn(m, x)
    out.float().square().sum().backward()
    return out.detach(), {k: p.grad for k, p in m.named_parameters()}


def _calibrate(m, x, fn):
    layers.name_quant_convs(m)
    with torch.no_grad(), layers.quant_context(
            "calibrate", min_channels=1) as ctx:
        out = fn(m, x)
    return out, ctx.stats


def _int8(m, x, fn):
    layers.name_quant_convs(m)
    scales = {name: 3.0 for name, mod in m.named_modules()
              if isinstance(mod, layers.Conv2d)}
    with torch.no_grad(), layers.quant_context("int8", scales,
                                               min_channels=1):
        return fn(m, x), {}


MODES = {"train_mode": _train, "grad_enabled": _grad,
         "calibrate": _calibrate, "int8": _int8}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["ResidualBlock.skip", "Bottleneck.down",
                                  "hrnet.BasicBlock.down", "ConvBN",
                                  "CenterNetHead", "SelfAttention.tower"])
def test_plain_route_where_the_kernel_does_not_engage(name, mode):
    """Train mode, a gradient wanted, calibration and int8 run today's
    ops: outputs, gradients, calibration maxima and BN statistics equal
    the old composition's; only `conv_epilogue.plain` moves."""
    build, shape, old, new, _ = CASES[name]
    m = randomize(build(torch.float32), seed=2)
    ref = copy.deepcopy(m)
    x = inputs(shape, torch.float32, seed=6)
    run = MODES[mode]
    (got, extra), n = counted(
        lambda: run(m, x, lambda mm, xx: run_new(name, mm, xx)))
    want, want_extra = run(ref, x, old)
    assert torch.equal(got, want)
    assert extra.keys() == want_extra.keys()
    for k, v in extra.items():
        assert (v is None) == (want_extra[k] is None), k
        assert v is None or torch.equal(v, want_extra[k]), k
    for (k, a), b in zip(m.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k
    assert n["conv_epilogue.kernel"] == 0 and n["conv_epilogue.plain"] > 0


def test_reference_is_the_op_by_op_chain():
    g = torch.Generator().manual_seed(7)
    for dt in DTYPES.values():
        y, r = (torch.randn(2, 5, 3, 4, generator=g).to(dt)
                for _ in range(2))
        b = torch.randn(5, generator=g).to(dt)
        want = F.relu((y + b[None, :, None, None]) + r)
        got = ce.conv_epilogue_reference(y, b, r, relu=True)
        assert torch.equal(got, want)
        assert torch.equal(ce.conv_epilogue(y, b, r, relu=True), want)
        assert torch.equal(ce.conv_epilogue_reference(y, b),
                           y + b[None, :, None, None])
        assert ce.conv_epilogue_reference(y) is y


def test_fits_takes_channels_last_alone():
    y = torch.zeros(2, 8, 5, 3)
    cl = y.contiguous(memory_format=CL)
    assert ce.fits(cl) and not ce.fits(y)
    assert ce.fits(torch.zeros(2, 1, 5, 3))       # C = 1: NCHW is NHWC
    assert ce.fits(cl, torch.zeros_like(cl))
    assert not ce.fits(cl, y)                     # other strides
    assert not ce.fits(cl, cl.to(torch.bfloat16))
    assert ce.fits(cl.to(torch.bfloat16), cl)    # stage 2's f32 residual
    assert not ce.fits(cl, torch.zeros(1, 8, 5, 3).contiguous(
        memory_format=CL))


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def specials(t, gen):
    """t with NaN, +-inf and -0.0 written at random places."""
    flat = t.view(-1)
    n = flat.numel()
    for v in (float("nan"), float("inf"), float("-inf"), -0.0):
        idx = torch.randint(0, n, (max(1, n // 50),), generator=gen)
        flat[idx.to(t.device)] = v
    return t


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 10, 40, 256, 384])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cuda_kernel_equals_the_plain_chain(cuda_device, dt, c):
    dtype = DTYPES[dt]
    gen = torch.Generator().manual_seed(c)

    def draw(*shape):
        t = torch.randn(*shape, generator=gen).to(dtype)
        return specials(t, gen).to(cuda_device)

    y0 = draw(3, c, 7, 5).contiguous(memory_format=CL)
    b = draw(c)
    r = draw(3, c, 7, 5).contiguous(memory_format=CL)
    cases = [None, r]
    if dtype == torch.bfloat16:     # an f32 residual: an f32 result
        cases.append(r.float())
    for residual in cases:
        for relu in (False, True):
            want = ce.conv_epilogue_reference(y0, b, residual, relu)
            y = y0.clone()
            before = ce.launches
            got = ce.conv_epilogue(y, b, residual, relu)
            assert ce.launches == before + 1
            assert (got is y) == (got.dtype == dtype) and got.dtype == (
                want.dtype)
            torch.cuda.synchronize()
            assert got.is_contiguous(memory_format=CL)
            assert torch.equal(bits(got), bits(want)), (
                residual is None, relu, got.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("c", [40, 256])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cuda_cudnn_bias_is_the_kernel_bias(cuda_device, dt, c, depthwise):
    """cuDNN's convolution with its bias, dense or depthwise (as
    ShuffleNet's), channels-last, equals the same convolution without it
    finished by the kernel (PyTorch adds a cuDNN conv's bias as a
    separate elementwise pass)."""
    dtype = DTYPES[dt]
    g = torch.Generator().manual_seed(c)
    cin, groups = (c, c) if depthwise else (24, 1)
    x = torch.randn(2, cin, 17, 13, generator=g).to(dtype).to(
        cuda_device).contiguous(memory_format=CL)
    w = (0.2 * torch.randn(c, cin // groups, 3, 3, generator=g)).to(
        dtype).to(cuda_device).contiguous(memory_format=CL)
    b = torch.randn(c, generator=g).to(dtype).to(cuda_device)
    want = F.relu(layers.conv2d(x, w, b, padding=1, groups=groups))
    y = layers.conv2d(x, w, None, padding=1, groups=groups)
    assert y.is_contiguous(memory_format=CL)
    got = ce.conv_epilogue(y, b, relu=True)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
def test_cuda_raises_on_what_it_does_not_take(cuda_device):
    y = torch.zeros(2, 8, 5, 3, device=cuda_device)
    b = torch.zeros(8, device=cuda_device)
    before = ce.launches
    with pytest.raises(ValueError):
        ce.conv_epilogue(y, b)                          # NCHW, C > 1
    with pytest.raises(ValueError):
        ce.conv_epilogue(y.half().contiguous(memory_format=CL), b.half())
    with pytest.raises(ValueError):                     # bias dtype
        ce.conv_epilogue(y.contiguous(memory_format=CL), b.double())
    with pytest.raises(ValueError):                     # residual strides
        ce.conv_epilogue(y.contiguous(memory_format=CL), b, y)
    assert ce.launches == before
    m = randomize(layers.ResidualBlock(8, 8), seed=4).to(cuda_device)
    with torch.no_grad(), pytest.raises(ValueError):    # an NCHW block input
        m(y)                    # conv1 finishes; conv2's residual raises
    assert ce.launches == before + 1
    ce.conv_epilogue(y.contiguous(memory_format=CL), b, relu=True)
    ce.conv_epilogue(torch.zeros(2, 1, 5, 3, device=cuda_device),
                     b[:1])                             # C = 1
    assert ce.launches == before + 3


def small_rrnet(dtype_name, monkeypatch=None):
    cfg = tcfg.rrnet_config(**{
        "model.backbone": "tiny_hourglass", "model.dtype": dtype_name,
        "model.topk": 64, "model.stage2_rois": 16,
        "val.scales": (1.0, 1.25)})
    model = randomize(build_model(cfg, device="cpu"), seed=3)
    with torch.no_grad():       # wide class logits: no near-ties in top-k
        for i in range(2):
            getattr(model.hm, f"out{i}").weight.mul_(10.0)
    return cfg, model.to("cuda")


def old_eval_forward(self, x, bn=None, residual=None, relu=False):
    """`Conv2d.forward`'s eval form as the eager chain: cuDNN's biased
    conv on the cached (folded) weights, then the add and F.relu as
    ops."""
    return ce.conv_epilogue_reference(self.run(x, *self.eval_weights(bn)),
                                      None, residual, relu)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_call_sites_equal_the_old_composition(cuda_device, name, dt,
                                                   monkeypatch):
    """On the card: bit-equal to the old composition (cuDNN's biased
    convs, the adds and ReLUs as ops), every conv finished by the kernel."""
    build, shape, old, _, n_convs = CASES[name]
    m = randomize(build(DTYPES[dt]), seed=1).to(cuda_device)
    x = inputs(shape, DTYPES[dt]).to(cuda_device)
    before = ce.launches
    with torch.no_grad():
        got, n = counted(lambda: run_new(name, m, x))
    assert n == {"conv_epilogue.kernel": n_convs, "conv_epilogue.plain": 0}
    assert ce.launches == before + n_convs
    monkeypatch.setattr(layers.Conv2d, "forward", old_eval_forward)
    with torch.no_grad():
        want = old(m, x)
    assert got.dtype == want.dtype
    assert torch.equal(bits(got.contiguous()), bits(want.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_cuda_small_rrnet_equals_the_old_composition(cuda_device, dt,
                                                     monkeypatch):
    from rrnet_torch.evallib.infer import Evaluator
    cfg, model = small_rrnet(dt)
    g = torch.Generator().manual_seed(9)
    x = torch.randn(2, 3, 96, 128, generator=g).to(cuda_device).contiguous(
        memory_format=CL)
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (90, 120, 3)).astype(np.uint8)
            for _ in range(2)]
    ev = Evaluator(cfg, model, device="cuda", bucket_multiple=64)
    with torch.no_grad():
        (out, rows), n = counted(lambda: (model(x), ev.predict_batch(imgs)))
    assert n["conv_epilogue.kernel"] > 0
    assert n["conv_epilogue.plain"] == 0            # hit share 1.0
    monkeypatch.setattr(layers.Conv2d, "forward", old_eval_forward)
    with torch.no_grad():
        want, want_rows = model(x), ev.predict_batch(imgs)
    for a, b in zip(out.hms + out.whs + out.offsets + (out.stage2_reg,),
                    want.hms + want.whs + want.offsets
                    + (want.stage2_reg,)):
        assert torch.equal(bits(a.contiguous()), bits(b.contiguous()))
    assert torch.equal(out.rois, want.rois)
    assert len(rows) == len(want_rows)
    for a, b in zip(rows, want_rows):
        assert a.shape == b.shape and np.array_equal(a, b)
