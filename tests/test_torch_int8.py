"""The port's int8 post-training quantization against the JAX package's
(`rrnet_tpu/models/layers.py`: `QuantCtx`, `quant_context`, the int8
branch of `Conv2d`), on the CPU, where the port's wrappers run their
plain versions.

The same numpy inputs go to both. Quantized activations, weights and
scales are compared bit for bit with the JAX package's arithmetic, line
by line (layers.py:154-164); convolution outputs in f32 bit for bit with
the JAX `Conv2d` under `quant_context("int8")` (the int32 accumulation is
exact on both sides, and the dequantize and bias are one IEEE operation
each). Calibration scales: the first conv sees the same input and its
absmax is equal; a later conv's input comes from an f32 convolution that
sums in another order in the two frameworks, so its absmax is held
within 1e-6 relative. Eligibility: the counts of each preset at full
width (built on the meta device) equal the JAX package's
`quantized_convs` in `SYNTH_AP.json`, and every conv the port marks not
quantizable is a flax `nn.Conv` in the JAX model.

The int8 kernels against their plain versions need a card; the machine
with the card has no JAX, so JAX is imported inside the tests that use it
(`jx()`), and there the CUDA cases run with

    python -m pytest --noconftest -m cuda tests/test_torch_int8.py
"""

import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

from rrnet_torch import config as tcfg
from rrnet_torch.models import build_model as t_build
from rrnet_torch.models import layers as tlayers
from rrnet_torch.models.backbones.trident import TridentResNet as TTrident
from rrnet_torch.models.modules import SelfAttentionModule as TAttention
from rrnet_torch.ops import int8_conv as ic
from rrnet_torch.utils.from_flax import load_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jx():
    """The JAX side: jax, jnp, flax.linen and the JAX package's modules."""
    import jax
    import jax.numpy as jnp
    from flax import linen as fnn
    from rrnet_tpu import config as jcfg
    from rrnet_tpu.models import build_model as j_build
    from rrnet_tpu.models import layers as jlayers
    from rrnet_tpu.models.backbones.trident import TridentResNet
    from rrnet_tpu.models.modules import SelfAttentionModule
    return SimpleNamespace(jax=jax, jnp=jnp, fnn=fnn, cfg=jcfg,
                           build=j_build, layers=jlayers,
                           Trident=TridentResNet,
                           Attention=SelfAttentionModule)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def jax_quant(x, kernel, absmax):
    """layers.py:154-164, line by line: (xq, wq, s_w) of an NHWC input and
    an HWIO kernel."""
    jnp = jx().jnp
    s_in = absmax / 127.0
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) * (1.0 / s_in)),
                  -127, 127).astype(jnp.int8)
    wf = kernel.astype(jnp.float32)
    w_absmax = jnp.maximum(jnp.max(jnp.abs(wf), axis=(0, 1, 2)), 1e-12)
    s_w = w_absmax / 127.0
    wq = jnp.clip(jnp.round(wf / s_w), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(wq), np.asarray(s_w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.6])
def test_quantized_values_bit_equal_jax(dtype, clip):
    """int8 activations (as they arrive, f32 or bf16; `clip` < 1 puts the
    scale below the data's absmax so values saturate at +-127), int8
    weights and s_w, with one all-zero output channel (the 1e-12 floor)."""
    jnp = jx().jnp
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 40).astype(np.float32) * 3.0
    kernel = rng.randn(3, 3, 40, 24).astype(np.float32) * 0.2
    kernel[..., 5] = 0.0
    jx_ = jnp.asarray(x).astype(dtype)
    absmax = float(jnp.max(jnp.abs(jx_)).astype(jnp.float32)) * clip
    xq, wq, s_w = jax_quant(jx_, jnp.asarray(kernel), absmax)
    tx = torch.from_numpy(np.array(jx_.astype(jnp.float32))).to(
        tlayers.dtype_of(dtype))
    got_x = ic.quantize_activation(tx, absmax)
    got_w, got_s = ic.quantize_weight(torch.from_numpy(
        kernel.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(got_x.numpy(), xq)
    np.testing.assert_array_equal(got_w.numpy().transpose(2, 3, 1, 0), wq)
    np.testing.assert_array_equal(got_s.numpy(), s_w)
    assert np.abs(xq).max() == 127
    # the packed forms hold the same values
    packed = ic.quantize_pack_plain(tx.permute(0, 3, 1, 2).contiguous(),
                                    absmax)
    assert packed.shape == (2, 9, 11, 48)
    np.testing.assert_array_equal(packed[..., :40].numpy(), xq)
    assert not packed[..., 40:].any()
    pw = ic.pack_weight(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    assert pw.rows.shape == (24, 448)         # 9 taps x 48, to 64s
    rows = pw.rows[:, :432].reshape(24, 3, 3, 48)
    np.testing.assert_array_equal(rows[..., :40].numpy().transpose(1, 2, 3, 0),
                                  wq)
    assert not rows[..., 40:].any() and not pw.rows[:, 432:].any()


# (kernel, stride, JAX padding, the same per side, bias, cin)
CONV_CASES = [
    (3, 1, [(1, 1), (1, 1)], (1, 1, 1, 1), True, 64),
    (3, 2, [(1, 1), (1, 1)], (1, 1, 1, 1), False, 48),
    (1, 1, "SAME", (0, 0, 0, 0), True, 40),
    (1, 2, "SAME", (0, 0, 0, 0), False, 32),
    # SAME at stride 2 on an even input pads one row/column after only
    (3, 2, "SAME", (0, 1, 0, 1), True, 64),
    (3, 1, [(2, 0), (0, 1)], (2, 0, 0, 1), True, 32),
]


@pytest.mark.parametrize("k,stride,jpad,pad4,bias,cin", CONV_CASES)
def test_int8_conv_bit_equal_jax_conv2d(k, stride, jpad, pad4, bias, cin):
    """The port's quantize_pack + int8_conv2d (plain versions, f32 out)
    against the JAX `Conv2d` at the top level under
    quant_context("int8", {"": absmax}): bit-equal; the int32 accumulator
    mode equals the exact integer convolution."""
    J = jx()
    jax, jnp, jlayers = J.jax, J.jnp, J.layers
    rng = np.random.RandomState(k * 10 + stride + cin)
    x = np.maximum(rng.randn(2, 12, 14, cin), 0).astype(np.float32)
    conv = jlayers.Conv2d(24, (k, k), strides=(stride, stride), padding=jpad,
                          use_bias=bias)
    v = jax.tree.map(np.asarray, conv.init(jax.random.PRNGKey(1),
                                           jnp.asarray(x)))
    if bias:
        v["params"]["bias"] = (rng.randn(24) * 0.3).astype(np.float32)
    absmax = float(np.abs(x).max()) * 0.9
    with jlayers.quant_context("int8", {"": absmax}):
        want = np.asarray(conv.apply(v, jnp.asarray(x)))
    w = torch.from_numpy(v["params"]["kernel"].transpose(3, 2, 0, 1).copy())
    b = torch.from_numpy(v["params"]["bias"]) if bias else None
    xq = ic.quantize_pack(nchw(x), absmax)
    pw = ic.pack_weight(w)
    got = ic.int8_conv2d(xq, pw, absmax / 127.0, b, stride, pad4,
                         torch.float32)
    np.testing.assert_array_equal(nhwc(got), want)
    acc = ic.int8_conv2d(xq, pw, absmax / 127.0, b, stride, pad4,
                         torch.int32)
    xj, wj, _ = jax_quant(jnp.asarray(x), jnp.asarray(v["params"]["kernel"]),
                          absmax)
    exact = jax.lax.conv_general_dilated(
        jnp.asarray(xj, jnp.int32), jnp.asarray(wj, jnp.int32), (stride,) * 2,
        jpad, dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(nhwc(acc), np.asarray(exact))


def _jnet():
    """The JAX side of _TNet."""
    J = jx()
    fnn, jlayers = J.fnn, J.layers

    class JNet(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.relu(jlayers.Conv2d(64, (3, 3), padding=[(1, 1), (1, 1)],
                                        name="c1")(x))
            x = fnn.relu(jlayers.Conv2d(48, (3, 3), strides=(2, 2),
                                        padding=[(1, 1), (1, 1)],
                                        use_bias=False, name="c2")(x))
            return jlayers.Conv2d(40, (1, 1), name="c3")(x)

    return JNet()


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = tlayers.Conv2d(40, 64, 3, 1, 1)
        self.c2 = tlayers.Conv2d(64, 48, 3, 2, 1, bias=False)
        self.c3 = tlayers.Conv2d(48, 40, 1)

    def forward(self, x):
        x = torch.relu(self.c1(x))
        return self.c3(torch.relu(self.c2(x)))


@pytest.fixture(scope="module")
def two_nets():
    J = jx()
    jax, jnp = J.jax, J.jnp
    rng = np.random.RandomState(2)
    x = rng.randn(2, 18, 22, 40).astype(np.float32)
    jn = _jnet()
    v = jax.tree.map(np.asarray, jn.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    v["params"]["c1"]["bias"] = (rng.randn(64) * 0.1).astype(np.float32)
    v["params"]["c3"]["bias"] = (rng.randn(40) * 0.1).astype(np.float32)
    tn = tlayers.name_quant_convs(load_flax_variables(_TNet(), v))
    return jn, v, tn, x


def test_calibrate_and_int8_forward_match_jax(two_nets):
    """Stride 2, 1x1, bias and no bias through a small net: calibration
    scales (keys the scope paths on both sides), then the int8 forward
    with the same scales bit-equal to JAX's, and near the float one."""
    J = jx()
    jax, jnp, jlayers = J.jax, J.jnp, J.layers
    jn, v, tn, x = two_nets
    with jlayers.quant_context("calibrate"):
        _, st = jn.apply(v, jnp.asarray(x), mutable=["quant_stats"])
    want = jlayers.quant_scales_from_stats(jax.device_get(st["quant_stats"]))
    with torch.no_grad(), tlayers.quant_context("calibrate") as ctx:
        ref = tn(nchw(x))
    got = tlayers.quant_scales_from_stats(ctx.stats)
    assert set(got) == set(want) == {"c1", "c2", "c3"}
    assert got["c1"] == want["c1"]
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
    with jlayers.quant_context("int8", want):
        yj = np.asarray(jn.apply(v, jnp.asarray(x)))
    with torch.no_grad(), tlayers.quant_context("int8", want):
        yt = nhwc(tn(nchw(x)))
    np.testing.assert_array_equal(yt, yj)
    rel = np.abs(yt - nhwc(ref)).max() / np.abs(nhwc(ref)).max()
    assert 0 < rel < 0.05, rel


def test_thin_and_grouped_convs_stay_exempt():
    """cin < min_channels (stems) and grouped convs neither calibrate nor
    quantize, as in the JAX package."""
    rng = np.random.RandomState(3)
    thin = tlayers.Conv2d(16, 32, 3, 1, 1)
    grouped = tlayers.Conv2d(48, 48, 3, 1, 1, groups=4)
    for m in (thin, grouped):
        tlayers.init_weights(m, torch.Generator().manual_seed(0))
        m.quant_name = "c"
        x = torch.from_numpy(rng.randn(1, m.weight.shape[1] * m.groups, 8, 8)
                             .astype(np.float32))
        with torch.no_grad():
            ref = m(x)
            with tlayers.quant_context("calibrate") as ctx:
                m(x)
            assert ctx.stats == {}
            with tlayers.quant_context("int8", {"c": 1.0}):
                assert torch.equal(m(x), ref)
    # a scale of 0 or no scale: the float path
    wide = tlayers.name_quant_convs(_TNet())
    tlayers.init_weights(wide, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.randn(1, 40, 8, 8).astype(np.float32))
    with torch.no_grad():
        ref = wide(x)
        with tlayers.quant_context("int8", {"c1": 0.0}):
            assert torch.equal(wide(x), ref)


def test_quant_context_scoping_and_no_leaks(two_nets):
    """Contexts nest and restore, refuse unknown modes, are invisible to
    another thread, and leave no trace once closed; a conv with no name
    under a context raises."""
    assert tlayers.current_quant() is None
    with tlayers.quant_context("calibrate"):
        assert tlayers.current_quant().mode == "calibrate"
        with tlayers.quant_context("int8", {}):
            assert tlayers.current_quant().mode == "int8"
            seen = []
            th = threading.Thread(
                target=lambda: seen.append(tlayers.current_quant()))
            th.start()
            th.join()
            assert seen == [None]
        assert tlayers.current_quant().mode == "calibrate"
    assert tlayers.current_quant() is None
    with pytest.raises(ValueError):
        with tlayers.quant_context("fp4"):
            pass
    _, _, tn, x = two_nets
    with torch.no_grad():
        ref = tn(nchw(x))
        with tlayers.quant_context("int8", {"c1": 1.0, "c2": 1.0,
                                            "c3": 1.0}):
            pass
        assert torch.equal(tn(nchw(x)), ref)
    unnamed = tlayers.Conv2d(40, 8, 1)
    tlayers.init_weights(unnamed, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="name_quant_convs"):
        with tlayers.quant_context("calibrate"):
            unnamed(nchw(x))


def test_packed_weight_made_once_and_dropped(two_nets):
    """A weight is quantized and packed once; a weight swap (in place, as
    load_state_dict does) or drop_int8_weights makes a new pack."""
    _, v, _, x = two_nets
    tn = tlayers.name_quant_convs(load_flax_variables(_TNet(), v))
    scales = {"c1": 4.0, "c2": 2.0, "c3": 1.0}
    with torch.no_grad(), tlayers.quant_context("int8", scales):
        tn(nchw(x))
        first = tn.c1.packed_weight()
        tn(nchw(x))
        assert tn.c1.packed_weight() is first
        sd = {k: t * 0.5 for k, t in tn.state_dict().items()}
    tn.load_state_dict(sd)
    again = tn.c1.packed_weight()
    assert again is not first
    assert torch.equal(again.s_w, first.s_w * 0.5)
    tlayers.drop_int8_weights(tn)
    assert all(m._int8 is None for m in (tn.c1, tn.c2, tn.c3))


def test_int8_conv_refuses_outside_its_contract():
    xq = torch.zeros(1, 4, 4, 32, dtype=torch.int8)
    pw = ic.pack_weight(torch.ones(8, 32, 3, 3))
    with pytest.raises(ValueError, match="groups 1 and dilation 1"):
        ic.int8_conv2d(xq, pw, 1.0, groups=2)
    with pytest.raises(ValueError, match="groups 1 and dilation 1"):
        ic.int8_conv2d(xq, pw, 1.0, dilation=2)
    with pytest.raises(TypeError):
        ic.int8_conv2d(xq, pw, 1.0, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ic.int8_conv2d(xq.to("meta"), pw, 1.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ic.quantize_pack(torch.zeros(1, 32, 4, 4, device="meta"), 1.0)
    dilated = tlayers.Conv2d(32, 8, 3, 1, 2, dilation=2)
    tlayers.init_weights(dilated, torch.Generator().manual_seed(0))
    dilated.quant_name = "d"
    with pytest.raises(ValueError, match="dilation"):
        with tlayers.quant_context("int8", {"d": 1.0}):
            dilated(torch.ones(1, 32, 8, 8))


def eligible(model):
    return [name for name, m in model.named_modules()
            if isinstance(m, tlayers.Conv2d) and m.quantizable
            and m.groups == 1 and m.weight.shape[1] >= 32]


@pytest.mark.parametrize("family", ["rrnet", "centernet", "retinanet"])
def test_eligible_conv_counts_equal_jax_records(family):
    """Each preset at full width, built on the meta device, has as many
    eligible convs as the JAX package calibrated (`SYNTH_AP.json`
    quantized_convs: rrnet 162 with stage 2's trunk, centernet 159,
    retinanet 57 = ResNet-50's 53 convs less the 3-channel stem, plus
    the FPN's 5; its towers are flax nn.Conv)."""
    with open(os.path.join(REPO, "SYNTH_AP.json")) as f:
        rows = {r["family"]: r for r in json.load(f)["families"]}
    want = rows[family]["int8"]["quantized_convs"]
    cfg = tcfg.PRESETS[family]()
    with torch.device("meta"):
        model = t_build(cfg, device="meta")
    names = eligible(model)
    assert len(names) == want, names
    if family == "retinanet":
        assert sum(n.startswith("fpn.") for n in names) == 5
        assert not any(".cls_head." in n or ".loc_head." in n for n in names)


def jax_conv_kinds(module, *args, **kw):
    """{scope path with ".": "Conv2d" | "Conv"} of every JAX layers.Conv2d
    and flax nn.Conv an abstract init of `module` calls."""
    J = jx()
    jax, fnn, jlayers = J.jax, J.fnn, J.layers
    found = {}

    def interceptor(next_fun, a, k, context):
        m = context.module
        if context.method_name == "__call__" and isinstance(
                m, (jlayers.Conv2d, fnn.Conv)):
            found[".".join(m.scope.path)] = type(m).__name__
        return next_fun(*a, **k)

    with fnn.intercept_methods(interceptor):
        jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a,
                                              **kw), *args)
    return found


def _tiny(family):
    J = jx()
    kv = {"rrnet": {"model.backbone": "tiny_hourglass", "model.topk": 64,
                    "model.stage2_rois": 16},
          "retinanet": {"model.backbone": "resnet10"}}[family]
    jc = J.cfg.PRESETS[family](**kv)
    tc = tcfg.PRESETS[family](**kv)
    return (J.build(jc), (J.jnp.zeros((1, 64, 64, 3)),), {"train": False},
            t_build(tc, device="meta"))


@pytest.mark.parametrize("which", ["rrnet", "retinanet", "attention",
                                   "trident"])
def test_non_quantizable_convs_are_jax_nn_convs(which):
    """Every port Conv2d marked quantizable=False is a flax nn.Conv in the
    JAX model and every other one a JAX layers.Conv2d (the stems, the
    JAX package's _StemConv, have 3 input channels and never qualify)."""
    J = jx()
    jnp = J.jnp
    if which in ("rrnet", "retinanet"):
        jm, args, kw, tm = _tiny(which)
    elif which == "attention":
        jm = J.Attention(key_channels=32, value_channels=32, out_channels=64,
                        kernel_size=5, dilation=6, padding=12)
        args, kw = (jnp.zeros((1, 16, 16, 64)),), {}
        with torch.device("meta"):
            tm = TAttention(64, 32, 32, out_channels=64, kernel_size=5,
                            dilation=6, padding=12)
    else:
        jm = J.Trident(depth=50, deform=True)
        args, kw = (jnp.zeros((1, 64, 64, 3)),), {"train": False}
        with torch.device("meta"):
            tm = TTrident(depth=50, deform=True)
    kinds = jax_conv_kinds(jm, *args, **kw)
    marked, plain = [], []
    for name, m in tm.named_modules():
        if not isinstance(m, tlayers.Conv2d):
            continue
        if name not in kinds:
            assert m.weight.shape[1] < 32, name       # a stem
            continue
        (plain if m.quantizable else marked).append(name)
        assert kinds[name] == ("Conv2d" if m.quantizable else "Conv"), name
    assert marked
    if which != "attention":
        assert plain if which != "trident" else not plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the int8 kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,jpad,pad4,bias,cin", CONV_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_bit_equal_plain(cuda_device, k, stride, jpad, pad4,
                                      bias, cin, dtype):
    rng = np.random.RandomState(cin + k)
    x = torch.from_numpy(rng.randn(3, cin, 37, 29).astype(np.float32)
                         ).to(cuda_device, dtype)
    w = torch.from_numpy(rng.randn(136, cin, k, k).astype(np.float32) * 0.1
                         ).to(cuda_device)
    b = (torch.from_numpy(rng.randn(136).astype(np.float32)).to(cuda_device)
         if bias else None)
    absmax = float(x.abs().amax()) * 0.8
    pw = ic.pack_weight(w)
    xq = ic.quantize_pack(x, absmax)
    torch.cuda.synchronize()
    assert torch.equal(xq, ic.quantize_pack_plain(x, absmax))
    for out in (torch.int32, dtype):
        got = ic.int8_conv2d(xq, pw, absmax / 127.0, b, stride, pad4, out)
        torch.cuda.synchronize()
        want = ic.int8_conv2d_plain(xq, pw.wq, pw.s_w, absmax / 127.0, b,
                                    stride, pad4, out)
        assert torch.equal(got, want)


@pytest.mark.cuda
@settings(max_examples=80, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(n=st.integers(1, 4), h=st.integers(1, 70), w=st.integers(1, 70),
       cin=st.integers(1, 512), cout=st.integers(1, 300),
       k=st.sampled_from([1, 3, 5]), stride=st.sampled_from([1, 2]),
       pad4=st.tuples(*[st.integers(0, 2)] * 4), bias=st.booleans(),
       bf16_in=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_cuda_conv_random_geometries_bit_equal(cuda_device, n, h, w, cin,
                                               cout, k, stride, pad4, bias,
                                               bf16_in, seed):
    """Random geometries: odd and even maps, stride 1 and 2, asymmetric
    pads, cout off the 128-channel tile, Cp 16-512, batch 1-4, split and
    unsplit K; int32, bf16 and f32 (+ bias) bit-equal to the plain
    versions."""
    ho = (h + pad4[0] + pad4[1] - k) // stride + 1
    wo = (w + pad4[2] + pad4[3] - k) // stride + 1
    assume(ho > 0 and wo > 0)
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    x = torch.randn(n, cin, h, w, device=cuda_device, generator=g)
    if bf16_in:
        x = x.to(torch.bfloat16)
    wt = torch.randn(cout, cin, k, k, device=cuda_device, generator=g)
    b = torch.randn(cout, device=cuda_device, generator=g) if bias else None
    absmax = float(x.abs().amax()) * 0.7
    pw = ic.pack_weight(wt)
    xq = ic.quantize_pack(x, absmax)
    for out in (torch.int32, torch.bfloat16, torch.float32):
        got = ic.int8_conv2d(xq, pw, absmax / 127.0, b, stride, pad4, out)
        torch.cuda.synchronize()
        want = ic.int8_conv2d_plain(xq, pw.wq, pw.s_w, absmax / 127.0, b,
                                    stride, pad4, out)
        assert torch.equal(got, want), (out, ho, wo)

