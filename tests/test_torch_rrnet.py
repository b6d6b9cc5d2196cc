"""The port's RRNet against the JAX package's, the weight converter at full
width, and the port's import isolation.

Sizes: tiny_hourglass, 64x64 inputs, topk 64, 16 ROIs, f32 on the CPU.
Tolerances: feature maps and head outputs atol/rtol 1e-4 (convolutions
sum in another order); ROI boxes within 1e-3 px; ROI classes, validity
and order equal. The flax `hm/out*` kernels are scaled up before the
weights are converted, so that heatmap logits spread and ~1e-6 framework
noise cannot reorder the top-k or the NMS.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rrnet_tpu import config as jcfg
from rrnet_tpu.models import build_model as j_build
from rrnet_torch import config as tcfg
from rrnet_torch.models import build_model as t_build
from rrnet_torch.models.rrnet import RRNet
from rrnet_torch.utils.from_flax import (check_state_shapes,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from tests.test_torch_layers import randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"model.backbone": "tiny_hourglass", "model.topk": 64,
        "model.stage2_rois": 16, "model.dtype": "float32"}
TOL = dict(atol=1e-4, rtol=1e-4)


def configs(**extra):
    kv = {**TINY, **extra}
    return jcfg.rrnet_config(**kv), tcfg.rrnet_config(**kv)


def tiny_pair(hm_scale=40.0, **extra):
    """(jax model, variables, port model) with the same weights."""
    jc, tc = configs(**extra)
    jm = j_build(jc)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 64, 64, 3)))
    v = randomize_bn(v, seed=1)
    for name, p in v["params"]["hm"].items():
        if name.startswith("out"):
            p["kernel"] = p["kernel"] * hm_scale
    tm = load_flax_variables(t_build(tc, device="cpu"), v)
    return jm, v, tm


def images(b=2, hw=(64, 64), seed=0):
    return np.random.RandomState(seed).randn(b, *hw, 3).astype(np.float32)


@pytest.mark.parametrize("nms_type", ["nms", "soft_nms"])
def test_rrnet_forward_matches_jax(nms_type):
    jm, v, tm = tiny_pair(**{"model.nms_type_for_stage1": nms_type})
    x = images()
    vhw = np.array([[64, 64], [50, 44]], np.int32)
    want = jax.jit(lambda v, x, h: jm.apply(v, x, train=False, valid_hw=h))(
        v, jnp.asarray(x), jnp.asarray(vhw))
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                 valid_hw=torch.from_numpy(vhw))
    for name in ("hms", "whs", "offsets"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got.roi_valid.numpy(),
                                  np.asarray(want.roi_valid))
    np.testing.assert_array_equal(got.roi_classes.numpy(),
                                  np.asarray(want.roi_classes))
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.roi_scores.numpy(),
                               np.asarray(want.roi_scores), **TOL)
    np.testing.assert_allclose(got.stage2_reg.numpy(),
                               np.asarray(want.stage2_reg), **TOL)
    assert got.roi_valid.any()


def test_select_rois_routes_soft_nms_by_class_mode(monkeypatch):
    """Per-class soft-NMS in `select_rois` takes the class-parallel route
    (its plain version on the CPU), with the ROIs of the serial route;
    class-agnostic soft-NMS takes the serial route; hard NMS takes
    `ops.hard_nms`."""
    from rrnet_torch.models import rrnet as trrnet
    from rrnet_torch.ops import hard_nms as thn
    from rrnet_torch.ops import soft_nms as tsn
    calls = []

    def spy(module, name):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **kw: (
            calls.append(name), real(*a, **kw))[1])

    spy(tsn, "soft_nms_classes_reference")
    spy(tsn, "soft_nms_reference")
    spy(thn, "hard_nms_reference")
    rng = np.random.RandomState(5)
    xy = rng.rand(2, 64, 2) * 40.0
    wh = rng.rand(2, 64, 2) * 12.0 + 2.0
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32))
    scores = torch.from_numpy(rng.beta(0.6, 2.5, (2, 64)).astype(np.float32))
    classes = torch.from_numpy(rng.randint(0, 10, (2, 64)).astype(np.int32))
    tm = RRNet(backbone="tiny_hourglass", topk=64, stage2_rois=16,
               nms_type="soft_nms", soft_nms_score_threshold=0.1)
    got = tm.select_rois(boxes, scores, classes)
    assert calls == ["soft_nms_classes_reference"]

    # the serial route on the same candidates
    serial = tsn.soft_nms_auto
    monkeypatch.setattr(trrnet, "soft_nms_auto", lambda *a, **kw: serial(
        *a, **{k: v for k, v in kw.items() if k != "class_parallel"}))
    want = tm.select_rois(boxes, scores, classes)
    assert calls[1:] == ["soft_nms_reference"]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[3].sum() == 32          # a full budget in both images

    monkeypatch.setattr(trrnet, "soft_nms_auto", serial)
    tm.nms_per_class = False
    tm.select_rois(boxes, scores, classes)
    tm.nms_type = "nms"
    tm.select_rois(boxes, scores, classes)
    assert calls[2:] == ["soft_nms_reference", "hard_nms_reference"]


def test_converter_maps_full_width_rrnet():
    """Every leaf of the real preset's parameter tree (hourglass-104, two
    stacks, 10 classes) lands on the port's state_dict with its shape."""
    jm = j_build(jcfg.rrnet_config(**{"model.nms_type_for_stage1":
                                      "soft_nms"}))
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                              train=False),
                            jnp.zeros((1, 64, 64, 3)))
    # zero-stride views: the shapes of a full-width tree without its bytes
    views = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    converted = numpy_state_from_flax(views)
    with torch.device("meta"):
        tm = RRNet(nms_type="soft_nms")
    expected = {k: t.shape for k, t in tm.state_dict().items()}
    check_state_shapes(expected, {k: a.shape for k, a in converted.items()})
    assert len(expected) == len(converted) > 800
    assert expected["backbone.pre_conv.weight"] == (128, 3, 7, 7)
    assert expected["wh.hconv1.weight"] == (1, 256, 17, 1)
    assert expected["head_detector.regressor.weight"] == (4, 256)


def test_converter_raises_on_missing_extra_or_unknown_leaf():
    jm, v, tm = tiny_pair()
    missing = {c: dict(t) for c, t in v.items()}
    del missing["params"]["head_detector"]
    with pytest.raises(ValueError, match="missing"):
        load_flax_variables(tm, missing)
    extra = {c: dict(t) for c, t in v.items()}
    extra["params"]["spare"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        load_flax_variables(tm, extra)
    odd = {c: dict(t) for c, t in v.items()}
    odd["params"]["spare"] = {"embedding": np.zeros((3, 2), np.float32)}
    with pytest.raises(ValueError, match="unmapped"):
        numpy_state_from_flax(odd)
    with pytest.raises(ValueError, match="unmapped collection"):
        numpy_state_from_flax({**v, "quant_stats": {}})


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of rrnet_torch and chip_smoke.py in a fresh
    interpreter; neither jax (nor flax, optax, orbax) nor rrnet_tpu may
    end up loaded."""
    code = r"""
import importlib, pathlib, sys
root = pathlib.Path("rrnet_torch")
mods = sorted(".".join(p.with_suffix("").parts).removesuffix(".__init__")
              for p in root.rglob("*.py"))
for m in mods + ["chip_smoke"]:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "orbax", "rrnet_tpu"))
print(len(mods), bad, mods)
assert not bad, bad
"""
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_mods = int(res.stdout.split()[0])
    assert n_mods >= 30
    for mod in ("rrnet_torch.train.trainer", "rrnet_torch.train.state",
                "rrnet_torch.train.criterions", "rrnet_torch.train.schedule",
                "rrnet_torch.utils.checkpoint", "rrnet_torch.ops.targets",
                "rrnet_torch.losses", "rrnet_torch.profile_train",
                "rrnet_torch.models.anchors", "rrnet_torch.models.retinanet",
                "rrnet_torch.models.modules",
                "rrnet_torch.models.backbones.resnet",
                "rrnet_torch.models.backbones.hrnet",
                "rrnet_torch.models.backbones.hrnetv2",
                "rrnet_torch.models.backbones.shufflenet",
                "rrnet_torch.parallel", "rrnet_torch.parallel.mesh"):
        assert mod in res.stdout, mod


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build(tc)
