"""The rest of the port's backbone registry (dense and SE hourglass,
ShuffleNetV2, the HRNet names) and the grouped convolution it needs, on
the CPU, against the JAX package.

Weights are drawn with numpy on the shapes of `jax.eval_shape` (BN
statistics included) and cross by `utils.from_flax`. Tolerances:
  * the dense and the SE hourglass at the tests' small hourglass size
    (depth 2, inplanes (64, 64, 96), one layer a level, two stacks; 64
    features, and 256 for the dense variant, which adds the stem's 256
    channels to each stack's output) at 64x64 and 72x100, and
    ShuffleNetV2 0.5x and 2.0x at 64x64, f32: each map within rtol 1e-4
    of its largest magnitude;
  * `conv2d` with `groups`: forward and f32 gradients equal to
    `F.conv2d`'s within 1e-6 of their largest magnitude;
  * the full-width trees of every new backbone: every leaf maps with its
    shape, and the parameter counts are equal;
  * the hourglass presets' state dicts: key for key, shape for shape and
    in order what they were before the per-stack widths (a digest).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rrnet_tpu.models.backbones import get_backbone as j_backbone
from rrnet_tpu.models.backbones.hourglass import HourglassNet as JHourglass
from rrnet_tpu.models.backbones.shufflenet import ShuffleNetV2 as JShuffle
from rrnet_torch.models import layers as tlayers
from rrnet_torch.models.backbones import get_backbone as t_backbone
from rrnet_torch.models.backbones.hourglass import HourglassNet
from rrnet_torch.models.backbones.shufflenet import ShuffleNetV2
from rrnet_torch.models.centernet import CenterNet
from rrnet_torch.models.rrnet import RRNet
from rrnet_torch.utils.from_flax import (check_state_shapes,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from tests.test_torch_hrnet import (close_maps, drawn_variables, nchw,
                                    variable_shapes)

SMALL_HG = dict(num_stacks=2, depth=2, inplanes=(64, 64, 96),
                layer_nums=(1, 1, 1))
# the dense variant adds the stem's 256-channel feature to each stack's
# output, so its stacks emit 256 channels
VARIANTS = {"dense": dict(dense=True, num_feats=256),
            "se": dict(se=True, pool_stem=True, num_feats=64)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("hw", [(64, 64), (72, 100)])
def test_hourglass_variant_matches_jax(variant, hw):
    kw = VARIANTS[variant]
    jm = JHourglass(**SMALL_HG, **kw)
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    v = drawn_variables(jm, x, seed=1)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = load_flax_variables(HourglassNet(**SMALL_HG, **kw).eval(), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        close_maps(g, w, 1e-4, f"{variant} stack {i}")
    if variant == "se":     # SE layers inside the recursion too
        assert tm.hg0.low2.low2_0.se is not None
        assert tm.pre_res.skip_conv.stride == 1
        assert float(got[0].min()) >= 0          # out_conv keeps its ReLU


def test_dense_hourglass_needs_256_features():
    """The stem's 256 channels are added to each stack's output: the JAX
    model fails on the broadcast, the port refuses to build."""
    jm = JHourglass(**SMALL_HG, dense=True, num_feats=64)
    with pytest.raises(TypeError, match="broadcast"):
        variable_shapes(jm, np.zeros((1, 64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="num_feats 256"):
        HourglassNet(**SMALL_HG, dense=True, num_feats=64)


@pytest.mark.parametrize("width", ["0.5x", "2.0x"])
def test_shufflenet_matches_jax(width):
    jm = JShuffle(width=width)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    v = drawn_variables(jm, x, seed=3)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = load_flax_variables(ShuffleNetV2(width=width).eval(), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1] == tm.out_channels[i]
        assert g.shape[-1] == 64 // (8 * 2 ** i)
        close_maps(g, w, 1e-4, f"{width} os{8 * 2 ** i}")


@pytest.mark.parametrize("width,channels", [
    ("0.5x", (48, 96, 1024)), ("1.0x", (116, 232, 1024)),
    ("1.5x", (176, 352, 1024)), ("2.0x", (224, 488, 2048))])
def test_shufflenet_output_widths(width, channels):
    tm = t_backbone(f"shufflenet_{width}").eval()
    assert tm.out_channels == channels
    with torch.no_grad():
        outs = tm(torch.zeros(1, 3, 32, 32))
    assert tuple(o.shape[1] for o in outs) == channels


@pytest.mark.parametrize("groups,stride", [(2, 1), (24, 2), (24, 1)])
def test_conv2d_groups_forward_and_f32_grads(groups, stride):
    rng = np.random.RandomState(groups + stride)
    x0 = torch.from_numpy(rng.randn(2, 24, 9, 11).astype(np.float32))
    w0 = torch.from_numpy(rng.randn(48, 24 // groups, 3, 3)
                          .astype(np.float32))
    b0 = torch.from_numpy(rng.randn(48).astype(np.float32))
    g_out = torch.from_numpy(rng.randn(2, 48, (9 - 1) // stride + 1,
                                       (11 - 1) // stride + 1)
                             .astype(np.float32))
    results = []
    for fn in (tlayers.conv2d, F.conv2d):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        y = fn(x, w, b, stride, 1, 1, groups)
        y.backward(g_out)
        results.append([y.detach(), x.grad, w.grad, b.grad])
    for name, got, want in zip(("y", "gx", "gw", "gb"), *results):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, atol=1e-6 * scale, rtol=0,
                                   msg=name)
    with torch.no_grad():
        torch.testing.assert_close(
            tlayers.conv2d(x0, w0, b0, stride, 1, 1, groups),
            results[1][0], atol=1e-6 * float(results[1][0].abs().max()),
            rtol=0)


def test_grouped_conv_init_counts_fan_in_per_group():
    """flax's fan-in of a (kh, kw, cin / groups, cout) kernel: a 3x3
    depthwise conv draws U(+-1/3), a dense one U(+-1/sqrt(9 cin))."""
    gen = torch.Generator().manual_seed(0)
    for groups, bound in ((24, 1 / 3), (1, 1 / np.sqrt(9 * 24))):
        conv = tlayers.Conv2d(24, 24, 3, 1, 1, bias=False, groups=groups)
        conv.reset_parameters_from(gen)
        assert conv.weight.shape == (24, 24 // groups, 3, 3)
        m = float(conv.weight.detach().abs().max())
        assert 0.95 * bound < m <= bound
    with pytest.raises(ValueError, match="groups"):
        tlayers.Conv2d(24, 30, 3, groups=4)


def test_se_dense_layers_have_no_bias_and_lecun_init():
    fc = tlayers.Linear(256, 16, bias=False, init="lecun")
    fc.reset_parameters_from(torch.Generator().manual_seed(1))
    assert sorted(dict(fc.named_parameters())) == ["weight"]
    std = 1 / np.sqrt(256)
    assert abs(float(fc.weight.std()) - std) < 0.1 * std
    assert float(fc.weight.abs().max()) <= 2 * std / .87962566103423978


NEW = ["hrnet", "hrnet32", "hrnetv2", "dense_hourglass", "se_hourglass",
       "shufflenet_0.5x", "shufflenet_1.0x", "shufflenet_1.5x",
       "shufflenet_2.0x"]


@pytest.mark.parametrize("name", NEW)
def test_full_width_tree_maps_with_its_shapes(name):
    """The JAX registry's module for `name` at full width: every leaf of
    its variables lands on the port's module of the same name."""
    jm = j_backbone(name, module_name="backbone")
    shapes = variable_shapes(jm, np.zeros((1, 64, 64, 3), np.float32))
    converted = numpy_state_from_flax(jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        shapes))
    with torch.device("meta"):
        tm = t_backbone(name)
    check_state_shapes({k: t.shape for k, t in tm.state_dict().items()},
                       {k: a.shape for k, a in converted.items()})
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("name", ["shufflenet_3x", "hrnetv3", "se-hourglass",
                                  "shufflenet_1.0x_b", "hrnet_w48"])
def test_misspelt_names_raise(name):
    with pytest.raises(NotImplementedError, match="not known"):
        t_backbone(name)


@pytest.mark.parametrize("model,n,digest", [
    ("rrnet", 845, "389e4144fb9fc492"),
    ("centernet", 828, "d5c3a4d0c0a80990"),
    ("rrnet_tiny", 275, "5f9be919b3d5f1e4")])
def test_hourglass_presets_state_dicts_unchanged(model, n, digest):
    """Keys, shapes and order of the hourglass detectors' state dicts, as
    they were before the heads took one width per stack (a digest taken
    on that tree): checkpoints and TrainState layouts still load."""
    with torch.device("meta"):
        m = {"rrnet": lambda: RRNet(), "centernet": lambda: CenterNet(),
             "rrnet_tiny": lambda: RRNet(backbone="tiny_hourglass")}[model]()
    sd = m.state_dict()
    text = ";".join(f"{k}:{tuple(v.shape)}" for k, v in sd.items())
    assert len(sd) == n
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == digest
