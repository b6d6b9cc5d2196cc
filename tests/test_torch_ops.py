"""The port's plain ops against the JAX package on the same numpy inputs:
box geometry, decode, top-k decode with ties, hard NMS, ROI-align,
heatmap extent masking and the YUV 4:2:0 transport.

Tolerances: f32 elementwise ops run the same operations in the same
order, so geometry and decode agree within 1e-6 relative; ROI-align sums
its samples in another order (1e-5). Indices, classes, keep sets and
every uint8 byte must be equal.
"""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rrnet_tpu.data import yuv420 as jyuv
from rrnet_tpu.models.rrnet import mask_heatmap_extent as j_mask
from rrnet_tpu.ops import box as jbox
from rrnet_tpu.ops import nms as jnms
from rrnet_tpu.ops.heatmap import topk_decode as j_topk
from rrnet_tpu.ops.roi_align import batched_roi_align
from rrnet_torch.data import yuv420 as tyuv
from rrnet_torch.models.rrnet import mask_heatmap_extent as t_mask
from rrnet_torch.ops import box as tbox
from rrnet_torch.ops import nms as tnms
from rrnet_torch.ops.heatmap import topk_decode as t_topk
from rrnet_torch.ops.roi_align import roi_align as t_roi_align


def T(a):
    return torch.from_numpy(np.array(a))


def boxes_xyxy(rng, n, span=50.0):
    xy = rng.rand(n, 2) * span
    wh = rng.rand(n, 2) * span * 0.4 + 0.5
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("plus_one", [False, True])
def test_box_ops_match(plus_one):
    rng = np.random.RandomState(0)
    a, b = boxes_xyxy(rng, 7), boxes_xyxy(rng, 9)
    np.testing.assert_allclose(
        tbox.pairwise_iou(T(a), T(b), plus_one=plus_one).numpy(),
        np.asarray(jbox.pairwise_iou(a, b, plus_one=plus_one)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tbox.box_area(T(a), plus_one).numpy(),
                               np.asarray(jbox.box_area(a, plus_one)),
                               rtol=1e-6)
    xywh = np.asarray(jbox.xyxy_to_xywh(a))
    np.testing.assert_allclose(tbox.xyxy_to_xywh(T(a)).numpy(), xywh)
    np.testing.assert_allclose(tbox.xywh_to_xyxy(T(xywh)).numpy(),
                               np.asarray(jbox.xywh_to_xyxy(xywh)))
    np.testing.assert_allclose(tbox.encode_boxes(T(a), T(b[:7])).numpy(),
                               np.asarray(jbox.encode_boxes(a, b[:7])),
                               rtol=1e-5, atol=1e-6)


def test_decode_boxes_matches():
    rng = np.random.RandomState(1)
    rois = np.abs(rng.randn(2, 16, 4).astype(np.float32)) * 20
    deltas = (rng.randn(2, 16, 4) * 0.3).astype(np.float32)
    # boxes within 1e-3 px
    np.testing.assert_allclose(tbox.decode_boxes(T(rois), T(deltas)).numpy(),
                               np.asarray(jbox.decode_boxes(rois, deltas)),
                               atol=1e-3, rtol=0)


def test_topk_decode_with_ties_and_mask():
    rng = np.random.RandomState(2)
    b, h, w, c = 2, 12, 10, 4
    hm = rng.randn(b, h, w, c).astype(np.float32)
    hm[:, :, :, 1] = 0.25            # a whole class plane of equal logits
    vhw = np.array([[36, 28], [48, 40]], np.int32)
    hm = np.asarray(j_mask(jnp.asarray(hm), jnp.asarray(vhw)))
    wh = (rng.rand(b, h, w, 2) * 6).astype(np.float32)
    off = rng.rand(b, h, w, 2).astype(np.float32)
    # k reaches past the valid extent, into the masked (sigmoid == 0) ties
    k = 400
    tj = j_topk(jnp.asarray(hm), jnp.asarray(wh), jnp.asarray(off), k=k,
                scale_factor=4.0)
    tt = t_topk(T(hm), T(wh), T(off), k=k, scale_factor=4.0)
    assert (np.asarray(tj.scores) == 0).sum() > 50     # ties really exist
    np.testing.assert_array_equal(tt.classes.numpy(), np.asarray(tj.classes))
    # sigmoid may round 1 ulp apart between the frameworks
    np.testing.assert_allclose(tt.scores.numpy(), np.asarray(tj.scores),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tt.boxes.numpy(), np.asarray(tj.boxes),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(tt.xs.numpy(), np.asarray(tj.xs), atol=1e-5)
    np.testing.assert_allclose(tt.ys.numpy(), np.asarray(tj.ys), atol=1e-5)
    assert tt.classes.dtype == torch.int32


def test_mask_heatmap_extent_matches():
    rng = np.random.RandomState(3)
    hm = rng.randn(3, 9, 11, 2).astype(np.float32)
    vhw = np.array([[33, 41], [36, 44], [1, 1]], np.int32)
    np.testing.assert_array_equal(
        t_mask(T(hm), T(vhw)).numpy(),
        np.asarray(j_mask(jnp.asarray(hm), jnp.asarray(vhw))))


@pytest.mark.parametrize("per_class", [True, False])
def test_hard_nms_matches(per_class):
    rng = np.random.RandomState(4)
    bsz, k = 3, 80
    boxes = np.stack([boxes_xyxy(rng, k) for _ in range(bsz)])
    scores = rng.rand(bsz, k).astype(np.float32)
    scores[:, ::7] = 0.5                 # equal scores: order by index
    valid = rng.rand(bsz, k) > 0.2
    cls = rng.randint(0, 3, (bsz, k)).astype(np.int32)
    got = tnms.hard_nms(T(boxes), T(scores), 0.3, valid=T(valid),
                        class_ids=T(cls) if per_class else None).numpy()
    want = jax.vmap(lambda b, s, v, c: jnms.hard_nms(
        b, s, 0.3, valid=v, class_ids=c if per_class else None))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
            jnp.asarray(cls))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_matches(dtype):
    rng = np.random.RandomState(5)
    b, h, w, c, r = 2, 13, 17, 8, 24
    feat = rng.randn(b, h, w, c).astype(np.float32)
    rois = np.stack([boxes_xyxy(rng, r, span=18.0) for _ in range(b)])
    # out-of-bounds and degenerate ROIs: fully outside, straddling the
    # border, below the 1-pixel minimum extent
    rois[:, 0] = [-9.0, -9.0, -3.0, -2.0]
    rois[:, 1] = [15.0, 10.0, 25.0, 19.0]
    rois[:, 2] = [-1.5, 4.0, 3.0, 20.0]
    rois[:, 3] = [5.0, 5.0, 5.2, 5.1]
    jfeat = jnp.asarray(feat).astype(dtype)
    want = np.asarray(batched_roi_align(jfeat, jnp.asarray(rois),
                                        output_size=(3, 3)))
    tfeat = T(feat).to(getattr(torch, dtype))
    got = t_roi_align(tfeat, T(rois), output_size=(3, 3))
    assert got.dtype == torch.float32 and got.shape == (b, r, 3, 3, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (want[:, 0] == 0).all()          # the ROI outside samples zeros


def test_yuv420_unpack_same_bytes():
    rng = np.random.RandomState(6)
    h, w = 24, 38
    flat = rng.randint(0, 256, (3, h * w * 3 // 2)).astype(np.uint8)
    want = np.asarray(jyuv.unpack_yuv420_device(jnp.asarray(flat), h, w))
    got = tyuv.unpack_yuv420_device(T(flat), h, w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_yuv420_pack_matches_numpy_path(monkeypatch):
    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (2, 20, 34, 3)).astype(np.uint8)
    # the JAX package packs with OpenCV when it is importable; hide it to
    # hold the port to that package's own numpy path
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(tyuv.pack_yuv420(rgb), jyuv.pack_yuv420(rgb))
    y_j, uv_j = jyuv.rgb_to_yuv420(rgb)
    y_t, uv_t = tyuv.rgb_to_yuv420(rgb)
    np.testing.assert_array_equal(y_t, y_j)
    np.testing.assert_array_equal(uv_t, uv_j)
