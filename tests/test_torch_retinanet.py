"""The port's RetinaNet (rrnet_torch.models.{anchors,retinanet,modules},
backbones.resnet, losses.focal_loss, criterions.retinanet_criterion and
the eval decode), on the CPU, against the JAX package.

Inputs come from numpy seeds; weights are the JAX models' own, carried
across by `utils.from_flax`, with BN statistics drawn at random.
Tolerances:
  * anchors: bitwise equal;
  * ResNet features (resnet10, resnet50 at 64x64, f32): rtol 1e-4 of
    each map's largest magnitude;
  * a resnet10 RetinaNet's (loc, cls) at 64x64 and at 72x100 (sides
    that are not multiples of 32: the FPN resizes 3 -> 5 -> 9 and
    4 -> 7 -> 13): atol 1e-4;
  * `focal_loss`: values and gradients rtol 1e-5; `retinanet_criterion`:
    losses rtol 1e-5, gradients rtol 1e-4 of their largest magnitude;
  * the decode on the same (loc, cls) arrays, with exact ties in the
    best-class score, through both Evaluators: rows (keep, rank, class)
    equal, boxes within 1e-3 px, scores within 1e-5;
  * `topk_desc` against `lax.top_k` on tied values: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu import config as jcfg
from rrnet_tpu import losses as JL
from rrnet_tpu.evallib.infer import Evaluator as JEvaluator
from rrnet_tpu.models import anchors as JA
from rrnet_tpu.models import build_model as j_build
from rrnet_tpu.models.backbones import get_backbone as j_backbone
from rrnet_tpu.train import criterions as JC
from rrnet_torch import config as tcfg
from rrnet_torch import losses as TL
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.models import anchors as TA
from rrnet_torch.models import build_model as t_build
from rrnet_torch.models.backbones import get_backbone as t_backbone
from rrnet_torch.models.retinanet import RetinaNet
from rrnet_torch.ops.heatmap import topk_desc
from rrnet_torch.train import criterions as TC
from rrnet_torch.utils.from_flax import (check_state_shapes,
                                         load_flax_train_state,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from tests.test_torch_eval_protocol import assert_rows_match, predict_both
from tests.test_torch_layers import randomize_bn
from tests.test_torch_train import close, random_annos

TINY = {"model.backbone": "resnet10", "model.dtype": "float32"}


def configs(**extra):
    kv = {**TINY, **extra}
    return jcfg.retinanet_config(**kv), tcfg.retinanet_config(**kv)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_preset_and_build():
    jc, tc = jcfg.retinanet_config(), tcfg.retinanet_config()
    assert tc == tcfg.PRESETS["retinanet"]()
    assert (tc.log_prefix, tc.model.name, tc.model.backbone) == (
        jc.log_prefix, jc.model.name, jc.model.backbone) == (
        "RetinaNet", "retinanet", "resnet50")
    assert tc.train.lr == jc.train.lr == 1e-4
    assert not tc.train.with_road and not tc.train.fill_duck
    assert tc.val.scales == jc.val.scales == (1.0,)
    assert not tc.val.auto_test and not tc.model.sync_bn
    for f in ("anchor_levels", "anchor_sizes", "anchor_ratios",
              "anchor_scales", "fpn_channels", "retina_pos_iou",
              "retina_neg_iou", "retina_alpha", "retina_gamma", "dtype"):
        assert getattr(tc.model, f) == getattr(jc.model, f), f
    assert isinstance(t_build(configs()[1], device="cpu"), RetinaNet)


@pytest.mark.parametrize("shape", [(64, 64), (128, 128), (768, 1408),
                                   (101, 173)])
def test_anchors_bitwise_equal_to_jax(shape):
    want = JA.anchors_for_shape(shape)
    got = TA.anchors_for_shape(shape)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TA.model_anchors(tcfg.retinanet_config().model, shape), want)
    # the cache hands out one read-only array
    assert TA.anchors_for_shape(shape) is got and not got.flags.writeable


def test_registry_raises_where_jax_falls_back():
    """The JAX registry builds resnet50 for a name it does not know; the
    port refuses it (ROADMAP A.6)."""
    assert type(j_backbone("resnet_typo")).__name__ == "ResNet"
    with pytest.raises(NotImplementedError, match="resnet_typo"):
        t_backbone("resnet_typo")


@pytest.mark.parametrize("name", ["resnet10", "resnet50"])
def test_resnet_matches_jax(name):
    jm = j_backbone(name, module_name="backbone")
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(1), x, train=False))(
        jnp.asarray(x))
    v = randomize_bn(v, seed=2)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    tm = load_flax_variables(t_backbone(name).eval(), v)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert tuple(g.shape) == w.shape == (
            2, 256 * 2 ** i, 16 // 2 ** i, 16 // 2 ** i)
        close(g.numpy(), w, rtol=1e-4, what=f"{name} l{i + 1}")


@pytest.fixture(scope="module")
def pair():
    """(jax model, variables, port model): a resnet10 RetinaNet, f32."""
    jc, tc = configs()
    jm = j_build(jc)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 64, 64, 3)))
    v = randomize_bn(v, seed=1)
    tm = load_flax_variables(t_build(tc, device="cpu"), v)
    return jm, v, tm


@pytest.mark.parametrize("hw", [(64, 64), (72, 100)])
def test_forward_matches_jax(pair, hw):
    jm, v, tm = pair
    x = np.random.RandomState(3).randn(2, *hw, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    n = len(JA.anchors_for_shape(hw))
    for g, w, c in zip(got, want, (4, 10)):
        assert tuple(g.shape) == w.shape == (2, n, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0)


def test_converter_maps_full_width_retinanet_and_its_train_state():
    """Every leaf of the preset's variables (ResNet-50, FPN-256, both
    towers) and of a JAX TrainState of it lands on the port's model and
    TrainState with its shape: no missing or extra key."""
    from rrnet_tpu.train.state import create_train_state as j_state
    from rrnet_torch.train.state import create_train_state as t_state

    jc, tc = jcfg.retinanet_config(), tcfg.retinanet_config()
    jm = j_build(jc)
    shapes = jax.eval_shape(lambda: j_state(
        jc, jm, jnp.zeros((1, 64, 64, 3)), jax.random.PRNGKey(0)))
    tree = {"step": shapes.step, "params": shapes.params,
            "batch_stats": shapes.batch_stats,
            "opt_state": shapes.opt_state}
    # zero-stride views: a full-width tree without its bytes
    tree = jax.tree.map(
        lambda s: np.broadcast_to(np.ones((), np.float32), s.shape), tree)
    converted = numpy_state_from_flax({"params": tree["params"],
                                       "batch_stats": tree["batch_stats"]})
    tm = t_build(tc, device="cpu")
    expected = {k: t.shape for k, t in tm.state_dict().items()}
    check_state_shapes(expected, {k: a.shape for k, a in converted.items()})
    n_params = sum(p.numel() for p in tm.parameters())
    assert n_params == sum(int(np.prod(s.shape)) for s in
                           jax.tree.leaves(shapes.params)) == 30_617_534
    assert expected["backbone.conv1.weight"] == (64, 3, 7, 7)
    assert expected["backbone.layer4_2.conv3.weight"] == (2048, 512, 1, 1)
    assert expected["fpn.lat5.weight"] == (256, 2048, 1, 1)
    assert expected["cls.out.weight"] == (90, 256, 3, 3)
    assert expected["loc.out.bias"] == (36,)
    state = load_flax_train_state(t_state(tc, tm, device="cpu"), tree)
    assert float(state.flat_params.min()) == 1.0
    assert int(state.step) == 1 and int(state.count) == 1


def test_head_biases_start_at_zero():
    """The JAX head is flax `nn.Conv`: zero bias, as the port's Conv2d."""
    tm = t_build(configs()[1], device="cpu")
    for name, p in tm.named_parameters():
        if name.startswith(("cls.", "loc.", "fpn.")) and name.endswith("bias"):
            assert not p.any(), name


# ---------------------------------------------------------------------------
# losses and the criterion
# ---------------------------------------------------------------------------

def test_focal_loss_matches_jax():
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 50, 10) * 4).astype(np.float32)
    logits[0, :3] = [[40.0] * 10, [-40.0] * 10, [0.0] * 10]   # the clamps
    targets = (rng.rand(3, 50, 10) < 0.1).astype(np.float32)
    for reduction in ("none", "sum"):
        want = JL.focal_loss(jnp.asarray(logits), jnp.asarray(targets),
                             gamma=2.0, alpha=0.75, reduction=reduction)
        got = TL.focal_loss(torch.from_numpy(logits),
                            torch.from_numpy(targets), gamma=2.0, alpha=0.75,
                            reduction=reduction)
        close(got.numpy(), want, rtol=1e-5, what=reduction)
    gw = jax.grad(lambda x: JL.focal_loss(x, jnp.asarray(targets)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    TL.focal_loss(x, torch.from_numpy(targets)).backward()
    close(x.grad.numpy(), gw, rtol=1e-5, what="grad")


def criterion_inputs(seed):
    """Predictions and GTs on the anchors of a 128x128 crop: random boxes
    (some invalid, some of zero width), two GTs duplicated (argmax ties go
    to the first), one image with no valid GT."""
    rng = np.random.RandomState(seed)
    anchors = JA.anchors_for_shape((128, 128))
    annos, valid = random_annos(3, 12, 128, seed=seed + 1)
    annos[:, :, 2:4] = annos[:, :, 2:4] * 2 + 4
    annos[0, 5] = annos[0, 2]
    annos[0, 5, 5] = (annos[0, 2, 5] % 10) + 1            # another class
    valid[0, [2, 5]] = True
    valid[2] = False
    loc = (rng.randn(3, len(anchors), 4) * 0.5).astype(np.float32)
    cls = (rng.randn(3, len(anchors), 10) * 2).astype(np.float32)
    return loc, cls, annos, valid, anchors


@pytest.mark.parametrize("seed", [0, 1])
def test_retinanet_criterion_matches_jax(seed):
    loc, cls, annos, valid, anchors = criterion_inputs(seed)
    kw = dict(pos_iou=0.5, neg_iou=0.4, alpha=0.75, gamma=2.0)

    def jloss(loc, cls):
        d = JC.retinanet_criterion(loc, cls, jnp.asarray(annos),
                                   jnp.asarray(valid), jnp.asarray(anchors),
                                   **kw)
        return d["cls"] + d["reg"], d

    (_, want), (g_loc, g_cls) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(loc),
                                             jnp.asarray(cls))
    tloc = torch.from_numpy(loc).requires_grad_()
    tcls = torch.from_numpy(cls).requires_grad_()
    got = TC.retinanet_criterion(tloc, tcls, torch.from_numpy(annos),
                                 torch.from_numpy(valid),
                                 torch.from_numpy(anchors.copy()), **kw)
    (got["cls"] + got["reg"]).backward()
    assert float(want["reg"]) > 0 and float(want["cls"]) > 0
    for k in ("cls", "reg"):
        close(float(got[k].detach()), float(want[k]), rtol=1e-5, what=k)
    close(tloc.grad.numpy(), g_loc, rtol=1e-4, what="grad loc")
    close(tcls.grad.numpy(), g_cls, rtol=1e-4, what="grad cls")


# ---------------------------------------------------------------------------
# the eval decode
# ---------------------------------------------------------------------------

def test_topk_desc_keeps_lax_top_k_tie_rule():
    rng = np.random.RandomState(5)
    x = rng.randint(0, 6, (3, 500)).astype(np.float32) / 8   # many ties
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 200)
    got_v, got_i = topk_desc(torch.from_numpy(x), 200)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


class _FixedJax:
    """A JAX model whose forward returns fixed (loc, cls) arrays."""

    def __init__(self, loc, cls):
        self.out = (loc, cls)

    def apply(self, variables, x, train=False):
        return tuple(jnp.asarray(a) for a in self.out)


class _FixedTorch(torch.nn.Module):
    def __init__(self, loc, cls):
        super().__init__()
        self.out = (torch.from_numpy(loc), torch.from_numpy(cls))

    def forward(self, x):
        return self.out


def decode_inputs(seed, n_anchors, b=3):
    """(loc, cls) of b images with logits on a coarse grid, so the
    best-class scores tie often (as sigmoids of bf16 logits do), and
    deltas that move boxes across each other."""
    rng = np.random.RandomState(seed)
    cls = np.round(rng.randn(b, n_anchors, 10) * 4) / 4 - 1.5
    loc = rng.randn(b, n_anchors, 4) * 0.8
    return loc.astype(np.float32), cls.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_jax_on_the_same_outputs(seed):
    """Both Evaluators on one batch of three images (90x100, 84x128,
    96x71 in a 96x128 bucket: the inside-extent mask bites), each model
    returning the same (loc, cls): 2268 anchors, top 1000, class-agnostic
    hard NMS at 0.3 with +1 extents."""
    from tests.test_torch_eval_protocol import frames
    jc, tc = configs()
    n = len(JA.anchors_for_shape((96, 128)))
    loc, cls = decode_inputs(seed, n)
    best = 1 / (1 + np.exp(-cls.max(-1)))
    assert len(np.unique(best)) < n // 20        # ties are everywhere
    je = JEvaluator(jc, {"params": {"w": jnp.zeros(1)}},
                    model=_FixedJax(loc, cls), bucket_multiple=32)
    te = TEvaluator(tc, _FixedTorch(loc, cls), device="cpu",
                    bucket_multiple=32)
    want, got = predict_both(je, te, frames(seed))
    assert_rows_match(got, want)
    for g, w in zip(got, want):
        # equal scores keep the anchors' order: rank and class equal too
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3, rtol=0)
        assert 0 < len(g) < 1000 and (g[:, 4] > 0.1).all()
