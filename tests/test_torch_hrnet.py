"""The port's HRNet family, `SelfAttentionModule` and the
`rrnet_hrnetv2_attention` preset's model (rrnet_torch.models.backbones.
{hrnet,hrnetv2}, models.modules, models.rrnet with attention and one
head width per stack, the converter), on the CPU, against the JAX
package. The preset's train step, Evaluator and CLIs are in
tests/test_torch_hrnet_train.py.

Inputs and weights come from numpy seeds: the weights are drawn on the
shapes of `jax.eval_shape` (no JAX `init` is compiled or run; a
full-width one takes half a minute on a CPU), BN statistics included,
and cross by `utils.from_flax`. Every attention output projection `W` is
drawn nonzero: at its zero init the module adds exactly 0 and a test of
it would test nothing. Tolerances:
  * a small HRNet (base 8, stage modules (1, 1, 1)), one map and four,
    at 64x64 and at 72x100 (branches 18x25 -> 9x13 -> 5x7 -> 3x4, where
    the fuse's nearest upsample is not a duplication), f32, eval and
    train mode: each map within rtol 1e-4 of its largest magnitude, the
    running statistics within rtol 1e-4; the HRNetV2 output upsample is
    `F.interpolate(align_corners=True)`, held to the JAX package's own
    formula within 1e-6;
  * `SelfAttentionModule`, f32: within 1e-5 of the largest magnitude;
  * the full-width preset's eval forward at 64x64 (topk 32, 8 ROIs):
    stage-1 maps within rtol 1e-4 of their largest magnitude, and its
    detection rows matched by `assert_rows_match` (boxes 1e-3 px,
    scores 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu import config as jcfg
from rrnet_tpu.models import build_model as j_build
from rrnet_tpu.models.backbones.hrnet import (
    _HRNetBase, _resize_bilinear_align_corners)
from rrnet_tpu.models.modules import SelfAttentionModule as JAttention
from rrnet_torch import config as tcfg
from rrnet_torch.models import build_model as t_build
from rrnet_torch.models.backbones.hrnet import (
    HRNet, resize_bilinear_align_corners)
from rrnet_torch.models.backbones.hrnetv2 import HRNetV2
from rrnet_torch.models.layers import init_weights
from rrnet_torch.models.modules import SelfAttentionModule as TAttention
from rrnet_torch.models.rrnet import RRNet
from rrnet_torch.ops.box import decode_boxes
from rrnet_torch.utils.from_flax import (check_state_shapes,
                                         load_flax_train_state,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from tests.test_torch_eval_protocol import assert_rows_match
from tests.test_torch_train import close
from torch_threads import one_torch_thread  # noqa: F401

PRESET = "rrnet_hrnetv2_attention"
SMALL = dict(base_channels=8, stage_modules=(1, 1, 1))
TINY = {"model.topk": 32, "model.stage2_rois": 8, "model.dtype": "float32"}


def configs(**extra):
    kv = {**TINY, **extra}
    return (jcfg.rrnet_hrnetv2_attention_config(**kv),
            tcfg.rrnet_hrnetv2_attention_config(**kv))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close_maps(got, want, rtol, what=""):
    """got (NCHW torch) against want (NHWC JAX) within rtol of the
    largest magnitude of want."""
    w = np.asarray(want).transpose(0, 3, 1, 2)
    g = got.detach().numpy()
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = float(np.abs(w).max())
    assert scale > 0, what
    np.testing.assert_allclose(g, w, atol=rtol * scale, rtol=0, err_msg=what)


def shape_heads(params):
    """Drawn head weights made detector-like: heatmap logits spread over
    a few units (no saturated, tied scores) and boxes a few feature
    pixels wide (the wh convs' biases), so that the ROIs overlap the GTs
    made from them and the top-k sees no near-ties."""
    for name, p in params["hm"].items():
        if name.startswith("out"):
            p["kernel"] = p["kernel"] * 4.0
    for name, p in params["wh"].items():
        if name.startswith(("hconv", "wconv")):
            p["bias"] = p["bias"] + 3.0
    return params


# ---------------------------------------------------------------------------
# the preset and the backbone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal_jax_field_for_field(name):
    """Every JAX preset has a port preset equal field for field, the
    `mesh` block included."""
    jd = dataclasses.asdict(jcfg.PRESETS[name]())
    assert dataclasses.asdict(tcfg.PRESETS[name]()) == jd
    assert sorted(tcfg.PRESETS) == sorted(jcfg.PRESETS)


@pytest.mark.parametrize("multi_scale", [False, True])
@pytest.mark.parametrize("hw", [(64, 64), (72, 100)])
def test_small_hrnet_matches_jax(multi_scale, hw):
    jm = _HRNetBase(last_multi_scale=multi_scale, **SMALL)
    x = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    v = drawn_variables(jm, x, seed=1)
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = load_flax_variables(HRNet(last_multi_scale=multi_scale,
                                   **SMALL).eval(), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == len(tm.out_channels) == (
        4 if multi_scale else 1)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape[1] == tm.out_channels[i] == 8 * 2 ** i
        close_maps(g, w, 1e-4, f"map {i}")


def test_small_hrnet_train_mode_matches_jax():
    """Train mode without norm_eval: batch statistics and their running
    update in both packages."""
    jm = _HRNetBase(last_multi_scale=True, **SMALL)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    v = drawn_variables(jm, x, seed=3)
    want, upd = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm = load_flax_variables(HRNet(last_multi_scale=True, **SMALL),
                             v).train()
    before = {k: b.clone() for k, b in tm.named_buffers()}
    got = tm(nchw(x))
    for i, (g, w) in enumerate(zip(got, want)):
        close_maps(g, w, 1e-4, f"map {i}")
    stats = numpy_state_from_flax({"batch_stats": jax.tree.map(
        np.asarray, upd["batch_stats"])})
    for k, b in tm.named_buffers():
        close(b.numpy(), stats[k], rtol=1e-4, what=k)
        assert not torch.equal(b, before[k]), k


def test_norm_eval_keeps_the_backbone_in_eval_mode():
    """With norm_eval the module stays in eval mode when its parent
    trains: running statistics, untouched (the JAX package's `bn_train
    = train and not norm_eval`; the train-step test below holds the
    result to the JAX Trainer's)."""
    parent = torch.nn.Sequential(init_weights(
        HRNetV2(**SMALL), torch.Generator().manual_seed(4))).train()
    tm = parent[0]
    assert parent.training and not tm.training
    assert not any(m.training for m in tm.modules())
    before = {k: b.clone() for k, b in tm.named_buffers()}
    tm(torch.randn(2, 3, 64, 64))
    assert all(torch.equal(b, before[k]) for k, b in tm.named_buffers())
    assert HRNet(**SMALL).train().training       # norm_eval off: trains


def test_align_corners_upsample_matches_jax_formula():
    x = np.random.RandomState(4).randn(2, 3, 5, 4).astype(np.float32)
    for oh, ow in ((18, 25), (5, 4)):
        want = _resize_bilinear_align_corners(jnp.asarray(x), oh, ow)
        got = resize_bilinear_align_corners(nchw(x), oh, ow)
        close_maps(got, want, 1e-6, f"{oh}x{ow}")


@pytest.mark.parametrize("geometry", [(5, 6, 12, 1, 1), (3, 2, 1, 2, 1),
                                      (3, 1, 1, 1, 2)])
def test_self_attention_matches_jax(geometry):
    """(kernel, dilation, padding, stride, scale): RRNet's window, a
    strided one whose result is resized back up, and one after a 2x2
    max-pool."""
    k, d, p, s, scale = geometry
    kw = dict(key_channels=8, value_channels=6, kernel_size=k, dilation=d,
              padding=p, stride=s, scale=scale)
    jm = JAttention(**kw)
    x = np.random.RandomState(5).randn(2, 18, 22, 12).astype(np.float32)
    v = drawn_variables(jm, x, seed=6)       # W drawn nonzero too
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = load_flax_variables(TAttention(12, **kw).eval(), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    close_maps(got, want, 1e-5)


def test_attention_output_projection_starts_at_zero():
    tm = t_build(configs()[1], device="cpu")
    for i in range(2):
        w = getattr(tm, f"attention{i}").W
        assert not w.weight.any() and not w.bias.any()
    x = torch.randn(1, 40, 9, 11)
    with torch.no_grad():
        assert not tm.attention0(x).any()


# ---------------------------------------------------------------------------
# the full-width preset
# ---------------------------------------------------------------------------

def draw_variables(shapes, seed):
    """Numpy variables for the shapes of a flax tree: kernels
    U(+-1/sqrt(fan_in)) (torch's init, every attention `W` included),
    biases small, BN affine and statistics as `randomize_bn`."""
    rng = np.random.RandomState(seed)

    def walk(tree, in_bn):
        out = {}
        for k, s in tree.items():
            if isinstance(s, dict):
                out[k] = walk(s, in_bn or k == "BatchNorm_0")
                continue
            shape = s.shape
            if in_bn and k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            elif in_bn:
                a = rng.randn(*shape) * 0.1
            elif k == "bias":
                a = rng.randn(*shape) * 0.01
            else:
                fan_in = int(np.prod(shape[:-1]))
                a = rng.uniform(-1, 1, shape) / np.sqrt(fan_in)
            out[k] = a.astype(np.float32)
        return out

    return walk(shapes, False)


def variable_shapes(module, x):
    """The shapes of `module`'s variables for input x (`eval_shape`: the
    init is traced, not run)."""
    return jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x,
                                                train=False), jnp.asarray(x))


def drawn_variables(module, x, seed):
    return draw_variables(variable_shapes(module, x), seed)


@pytest.fixture(scope="module")
def full():
    """The preset at full width (HRNetV2-w40, attention, two stacks;
    topk 32, 8 ROIs, f32) in both packages on drawn variables."""
    jc, tc = configs()
    jm = j_build(jc)
    shapes = variable_shapes(jm, np.zeros((1, 64, 64, 3), np.float32))
    v = draw_variables(shapes, seed=8)
    v["params"] = shape_heads(v["params"])
    tm = load_flax_variables(t_build(tc, device="cpu"), v)
    return jm, v, tm, shapes


def rows(outs, s=4.0):
    """(B, R, 6) detection rows [x, y, w, h, score, cls + 1] of RRNet
    outputs, as the Evaluator decodes them, valid rows only."""
    t = {k: torch.as_tensor(np.array(getattr(outs, k))) for k in
         ("rois", "stage2_reg", "roi_scores", "roi_classes", "roi_valid")}
    xyxy = t["rois"] * s
    xywh = decode_boxes(torch.cat([xyxy[..., :2], xyxy[..., 2:] -
                                   xyxy[..., :2]], -1), t["stage2_reg"])
    packed = torch.cat([xywh, t["roi_scores"][..., None],
                        t["roi_classes"][..., None].float() + 1.0], -1)
    return [p[v].numpy().astype(np.float64)
            for p, v in zip(packed, t["roi_valid"])]


def test_full_width_eval_forward_matches_jax(full):
    jm, v, tm, _ = full
    x = np.random.RandomState(9).randn(2, 64, 64, 3).astype(np.float32)
    vhw = np.array([[64, 64], [52, 60]], np.int32)
    want = jm.apply(v, jnp.asarray(x), train=False,
                    valid_hw=jnp.asarray(vhw))
    with torch.no_grad():
        feats = tm.backbone(nchw(x))
        att = tm.attention1(torch.relu(feats[1]))
        got = tm(nchw(x), valid_hw=torch.from_numpy(vhw))
    assert [f.shape[1] for f in feats] == [40, 80, 160, 320]
    assert float(att.abs().max()) > 1e-2          # W is not zero
    for name in ("hms", "whs", "offsets"):
        for i, (g, w) in enumerate(zip(getattr(got, name),
                                       getattr(want, name))):
            close_maps(g.permute(0, 3, 1, 2), np.asarray(w), 1e-4,
                       f"{name}[{i}]")
    g_rows, w_rows = rows(got), rows(want)
    assert all(len(r) == 8 for r in w_rows)
    assert_rows_match(g_rows, w_rows)


def test_converter_maps_full_width_preset_and_its_train_state(full):
    """Every leaf of the preset's variables (HRNetV2-w40, both attention
    modules, the per-stack heads at 40 and 80 channels, stage 2 on the
    320-channel map) and of a JAX TrainState of it lands on the port's
    model and TrainState with its shape."""
    from rrnet_tpu.train.state import create_train_state as j_state
    from rrnet_torch.train.state import create_train_state as t_state

    jm, _, tm, shapes = full
    converted = numpy_state_from_flax(jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
        shapes))
    expected = {k: t.shape for k, t in tm.state_dict().items()}
    check_state_shapes(expected, {k: a.shape for k, a in converted.items()})
    n_params = sum(p.numel() for p in tm.parameters())
    assert n_params == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        shapes["params"])) == 46_582_616
    assert expected["hm.conv0.weight"] == (256, 40, 3, 3)
    assert expected["wh.conv1.weight"] == (256, 80, 3, 3)
    assert expected["head_detector.top.conv1.weight"] == (64, 320, 1, 1)
    assert expected["attention1.f_key_conv1.weight"] == (64, 80, 1, 1)
    assert expected["attention0.W.weight"] == (40, 64, 1, 1)
    assert expected["backbone.stage3_2.fuse0_2_conv.weight"] == (40, 160, 1,
                                                                 1)
    assert expected["backbone.layer1_0.downsample_conv.weight"] == (
        256, 64, 1, 1)

    jc, tc = configs()
    st = jax.eval_shape(lambda: j_state(jc, jm, jnp.zeros((1, 64, 64, 3)),
                                        jax.random.PRNGKey(0)))
    tree = jax.tree.map(
        lambda s: np.broadcast_to(np.ones((), np.float32), s.shape),
        {"step": st.step, "params": st.params,
         "batch_stats": st.batch_stats, "opt_state": st.opt_state})
    state = load_flax_train_state(t_state(tc, tm, device="cpu"), tree)
    assert float(state.flat_params.min()) == 1.0 and int(state.step) == 1


def test_build_and_stack_count_refusal():
    model = t_build(tcfg.PRESETS[PRESET](), device="cpu")
    assert isinstance(model, RRNet) and model.with_attention
    assert model.backbone.norm_eval and not model.backbone.training
    # two stacks asked of a one-map HRNet: ValueError in the port, an
    # IndexError deep in the JAX model
    for name in ("hrnet32", "hrnet"):
        kv = {"model.backbone": name}
        with pytest.raises(ValueError, match="2 stacks"):
            t_build(tcfg.rrnet_config(**kv), device="meta")
        with pytest.raises(ValueError, match="2 stacks"):
            t_build(tcfg.centernet_config(**kv), device="meta")
    jm = j_build(jcfg.rrnet_config(**{"model.backbone": "hrnet32"}))
    with pytest.raises(IndexError):
        jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                         train=False),
                       jnp.zeros((1, 64, 64, 3)))
