"""The port's Predictor against the JAX package's, end to end on the CPU:
host staging, device preprocess, RRNet with stage-1 soft-NMS, stage-2
decode and host collect.

Both sides run f32 with the same converted weights (hm/out* kernels
scaled up, see test_torch_rrnet) on two images of different sizes in one
64x64 bucket. Detection rows must match in number, class and order;
boxes within 1e-3 px, scores within 1e-4. The yuv420 case hides OpenCV,
so that both sides pack with the same numpy code.
"""

import dataclasses
import sys

import numpy as np
import pytest

from rrnet_tpu.serving import Predictor as JPredictor
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.serving import Predictor as TPredictor
from tests.test_torch_rrnet import tiny_pair, configs


def requests(seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(60, 50, 3) * 255).astype(np.uint8),
            (rng.rand(56, 64, 3) * 255).astype(np.uint8)]


@pytest.fixture(scope="module")
def pair():
    extra = {"model.nms_type_for_stage1": "soft_nms"}
    jm, v, tm = tiny_pair(**extra)
    jc, tc = configs(**extra)
    return jm, v, tm, jc, tc


@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
def test_predict_batch_matches_jax(pair, transport, monkeypatch):
    jm, v, tm, jc, tc = pair
    if transport == "yuv420":
        monkeypatch.setitem(sys.modules, "cv2", None)
    jc = jc.replace(val=jc.val.__class__(transport=transport))
    tc = tc.replace(val=tc.val.__class__(transport=transport))
    jp = JPredictor(jc, v, model=jm, bucket_multiple=64)
    tp = TPredictor(tc, tm, device="cpu", bucket_multiple=64)
    imgs = requests()
    want = jp.predict_batch(imgs)
    got = tp.predict_batch(imgs)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1] == 6 and len(g) > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-4, rtol=1e-4)
        assert np.all(np.diff(g[:, 4]) <= 0)


def test_predictor_surface(pair):
    _, _, tm, _, tc = pair
    tp = TPredictor(tc, tm, device="cpu", bucket_multiple=64,
                    image_shapes=((60, 50),))
    assert tp.cfg.val.scales == (1.0,) and tp.cfg.val.flip_tta is False
    assert tp.warmup() == 1 and tp.warmed_up
    imgs = requests(1)
    whole = tp.predict_batch(imgs)
    piecewise = tp.collect(tp.dispatch(tp.stage(imgs)))
    for a, b in zip(whole, piecewise):
        np.testing.assert_array_equal(a, b)
    single = tp.predict(imgs[0])
    np.testing.assert_allclose(single, whole[0], atol=1e-4)
    stats = tp.latency_stats()
    assert stats["count"] == 2 and stats["p50_s"] > 0


def test_unported_eval_protocol_raises(pair):
    """deployment=False serves the preset's whole eval protocol (its six
    scales), as the Evaluator does; a family the port does not have
    raises."""
    _, _, tm, _, tc = pair
    multi = TPredictor(tc, tm, device="cpu", bucket_multiple=64,
                       deployment=False)
    assert multi.cfg.val.scales == tc.val.scales and len(tc.val.scales) == 6
    img = requests()[0]
    want = TEvaluator(tc, tm, device="cpu", bucket_multiple=64).predict(img)
    np.testing.assert_array_equal(multi.predict(img), want)
    assert len(want) > 0
    with pytest.raises(NotImplementedError):
        TEvaluator(tc.replace(model=dataclasses.replace(
            tc.model, name="ssd")), tm, device="cpu")
