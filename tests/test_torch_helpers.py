"""The public helpers of the ported modules that their JAX counterparts
have (`ops.box`, `ops.nms`, `ops.roi_align`, `ops.targets`, `losses`,
`utils.checkpoint`, `data.yuv420`), each against the JAX function on
seeded numpy inputs, on the CPU.

Tolerances: f32 elementwise arithmetic in the same order, rtol 1e-6 of
the largest magnitude (1e-5 where a mean or an exp and a log come in);
keep masks, indices and uint8 images equal; checkpoints bit-equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu import losses as jlosses
from rrnet_tpu.data import yuv420 as jyuv
from rrnet_tpu.ops import box as jbox
from rrnet_tpu.ops import nms as jnms
from rrnet_tpu.ops import targets as jtargets
from rrnet_torch import losses as tlosses
from rrnet_torch.data import yuv420 as tyuv
from rrnet_torch.ops import box as tbox
from rrnet_torch.ops import nms as tnms
from rrnet_torch.ops import targets as ttargets
from rrnet_torch.utils import checkpoint as tckpt
from tests.test_torch_train import close, random_annos
from torch_threads import one_torch_thread  # noqa: F401

# the packages' `ops` export the function `roi_align` under the module's name
jroi = importlib.import_module("rrnet_tpu.ops.roi_align")
troi = importlib.import_module("rrnet_torch.ops.roi_align")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def boxes_xyxy(rng, shape, extent=60.0):
    xy = rng.rand(*shape, 2) * extent - 5.0
    wh = rng.rand(*shape, 2) * 20.0
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_box_helpers_match_jax():
    rng = np.random.RandomState(0)
    a, b = boxes_xyxy(rng, (40,)), boxes_xyxy(rng, (40,))
    a[::5, 2:] = a[::5, :2] - 1.0           # inverted output boxes
    close(tbox.giou(t(a), t(b)).numpy(), jbox.giou(jnp.asarray(a),
                                                   jnp.asarray(b)),
          rtol=1e-6)
    close(tbox.giou_loss(t(a), t(b)).numpy(),
          jbox.giou_loss(jnp.asarray(a), jnp.asarray(b)), rtol=1e-5)
    assert tlosses.giou_loss is tbox.giou_loss
    xywh_a = np.concatenate([a[:, :2], np.abs(a[:, 2:] - a[:, :2])], -1)
    xywh_b = np.concatenate([b[:, :2], b[:, 2:] - b[:, :2]], -1)
    for plus_one in (False, True):
        close(tbox.pairwise_iou_xywh(t(xywh_a), t(xywh_b),
                                     plus_one=plus_one).numpy(),
              jbox.pairwise_iou_xywh(jnp.asarray(xywh_a),
                                     jnp.asarray(xywh_b),
                                     plus_one=plus_one), rtol=1e-6)
    c = rng.rand(3, 7, 4).astype(np.float32) * 50
    close(tbox.cxcywh_to_xyxy(t(c)).numpy(),
          jbox.cxcywh_to_xyxy(jnp.asarray(c)), rtol=1e-6)
    close(tbox.xyxy_to_cxcywh(t(c)).numpy(),
          jbox.xyxy_to_cxcywh(jnp.asarray(c)), rtol=1e-6)
    for img1, img0 in (((512, 512), (384, 512)), ((608, 416), (765, 1360))):
        close(tbox.scale_coords(img1, t(c), img0).numpy(),
              jbox.scale_coords(img1, jnp.asarray(c), img0), rtol=1e-6)


def nms_inputs(seed, b=3, k=60):
    rng = np.random.RandomState(seed)
    boxes = boxes_xyxy(rng, (b, k), extent=40.0)
    boxes[0, :8] -= 30.0                   # negative coordinates
    scores = rng.rand(b, k).astype(np.float32)
    classes = rng.randint(0, 4, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) > 0.2
    return boxes, scores, classes, valid


@pytest.mark.parametrize("with_valid", [False, True])
def test_batched_nms_matches_jax(with_valid):
    boxes, scores, classes, valid = nms_inputs(1)
    v = valid if with_valid else None
    want = jax.vmap(lambda bx, s, c, m: jnms.batched_nms(
        bx, s, c, 0.5, valid=m))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
        jnp.asarray(valid if with_valid else np.ones_like(valid)))
    got = tnms.batched_nms(t(boxes), t(scores), t(classes), 0.5,
                           valid=None if v is None else t(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()
    # the same keep set as per-class hard NMS
    per_class = tnms.hard_nms(t(boxes), t(scores), 0.5,
                              valid=None if v is None else t(v),
                              class_ids=t(classes))
    np.testing.assert_array_equal(got.numpy(), per_class.numpy())


def test_topk_after_nms_matches_jax():
    boxes, scores, classes, valid = nms_inputs(2)
    scores[1, 10:14] = scores[1, 9]         # ties: lower index first
    keep = tnms.batched_nms(t(boxes), t(scores), t(classes), 0.5,
                            valid=t(valid))
    for k in (5, 40, 60):
        want = jax.vmap(lambda bx, s, m: jnms.topk_after_nms(bx, s, m, k))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(keep.numpy()))
        got = tnms.topk_after_nms(t(boxes), t(scores), keep, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batched_roi_align_matches_jax():
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 12, 15, 5).astype(np.float32)
    rois = boxes_xyxy(rng, (2, 9), extent=14.0) / 1.5
    want = jroi.batched_roi_align(jnp.asarray(feats), jnp.asarray(rois),
                                  output_size=(3, 3), spatial_scale=1.0,
                                  sampling_ratio=2)
    got = troi.batched_roi_align(t(feats), t(rois), output_size=(3, 3),
                                 spatial_scale=1.0, sampling_ratio=2)
    close(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("agnostic", [False, True])
def test_render_centernet_targets_matches_jax(agnostic):
    annos, valid = random_annos(1, 45, 64, seed=4)
    want = jtargets.render_centernet_targets(
        jnp.asarray(annos[0]), jnp.asarray(valid[0]), feat_shape=(16, 16),
        scale_factor=4, num_classes=10, class_agnostic=agnostic)
    got = ttargets.render_centernet_targets(
        t(annos[0]), t(valid[0]), (16, 16), 4, 10, class_agnostic=agnostic)
    assert got.hm.shape == want.hm.shape
    close(got.hm.numpy(), want.hm, rtol=1e-5, what="hm")
    for name in ("wh", "offset", "reg_mask"):
        close(getattr(got, name).numpy(), getattr(want, name), rtol=1e-5,
              what=name)
    np.testing.assert_array_equal(got.ind.numpy(), np.asarray(want.ind))


def test_loss_helpers_match_jax():
    rng = np.random.RandomState(5)
    logits = (rng.randn(2, 8, 9, 10) * 3).astype(np.float32)
    gt = rng.rand(2, 8, 9, 10).astype(np.float32) ** 4
    gt[0, 1, 2, 3] = gt[1, 4, 5, 6] = 1.0
    close(tlosses.focal_loss_hm_from_logits(t(logits), t(gt)).numpy(),
          jlosses.focal_loss_hm_from_logits(jnp.asarray(logits),
                                            jnp.asarray(gt)), rtol=1e-5)
    sa, la = (rng.randn(2, 16, 32) * 0.5).astype(np.float32)
    sf, lf = (rng.randn(2, 16, 32) * 2).astype(np.float32)
    close(tlosses.kl_feature_loss(t(sa), t(la), t(sf), t(lf)).numpy(),
          jlosses.kl_feature_loss(jnp.asarray(sa), jnp.asarray(la),
                                  jnp.asarray(sf), jnp.asarray(lf)),
          rtol=1e-5)


def test_params_only_round_trip_matches_jax(tmp_path):
    from rrnet_tpu.utils import checkpoint as jckpt
    rng = np.random.RandomState(6)
    params = {"conv.weight": rng.randn(4, 3, 3, 3).astype(np.float32),
              "conv.bias": rng.randn(4).astype(np.float32),
              "bn.running_var": rng.rand(4).astype(np.float32)}
    path = tckpt.save_params_only(str(tmp_path / "export" / "params.pt"),
                                  {k: t(v) for k, v in params.items()})
    got = tckpt.load_params_only(path)
    jpath = jckpt.save_params_only(str(tmp_path / "jax_params"),
                                   {k.replace(".", "_"): jnp.asarray(v)
                                    for k, v in params.items()})
    want = jckpt.load_params_only(jpath)
    assert sorted(got) == sorted(params)
    for k, v in params.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        np.testing.assert_array_equal(np.asarray(want[k.replace(".", "_")]),
                                      v)


def test_yuv420_to_rgb_host_matches_jax():
    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (2, 10, 14, 3)).astype(np.uint8)
    # the same planes into both inverses: the JAX package packs with
    # OpenCV where it imports, the port with its numpy path
    y, uv = tyuv.rgb_to_yuv420(rgb)
    np.testing.assert_array_equal(tyuv.yuv420_to_rgb_host(y, uv),
                                  jyuv.yuv420_to_rgb_host(y, uv))
