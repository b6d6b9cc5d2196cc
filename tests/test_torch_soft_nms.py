"""The port's soft-NMS (rrnet_torch.ops.soft_nms) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, which is held to
the serial Pallas kernel in interpret mode, to the XLA formulation
(rrnet_tpu/ops/nms.py::soft_nms) and to the numpy oracle. Keep sets and
ranks must be equal; decayed scores agree within rtol 1e-5 (the same f32
operations in the same order, so only XLA's own rounding can differ).
The CUDA kernel against the plain version runs only where a card is;
the machine with the card has no JAX, so JAX is imported inside the
tests that use it, and there the CUDA cases run with

    python -m pytest --noconftest -m cuda tests/test_torch_soft_nms.py
"""

import numpy as np
import pytest
import torch

from rrnet_torch.ops import soft_nms as tsn


def dets(b, k, seed, span=100.0, n_cls=3):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, k, 2) * span
    wh = rng.rand(b, k, 2) * span * 0.3 + 1.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(b, k).astype(np.float32)
    cls = rng.randint(0, n_cls, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) > 0.15
    return boxes, scores, cls, valid


def port(boxes, scores, valid=None, cls=None, **kw):
    t = (lambda a: None if a is None else torch.from_numpy(np.asarray(a)))
    out = tsn.soft_nms(t(boxes), t(scores), t(valid), t(cls), **kw)
    return [o.numpy() for o in out]


CASES = [(m, pc) for m in ("gaussian", "linear", "hard") for pc in (True, False)]


@pytest.mark.parametrize("method,per_class", CASES)
def test_plain_matches_pallas_interpret(method, per_class):
    import jax.numpy as jnp
    from rrnet_tpu.ops.pallas_nms import soft_nms_pallas
    boxes, scores, cls, valid = dets(3, 90, seed=11)
    kw = dict(sigma=0.5, iou_threshold=0.3, score_threshold=0.2,
              method=method, max_out=25)
    ns, keep, rank = port(boxes, scores, valid, cls if per_class else None,
                          **kw)
    for i in range(3):
        jns, jkeep, jrank = soft_nms_pallas(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(valid[i]),
            jnp.asarray(cls[i]) if per_class else None,
            per_class=per_class, interpret=True, **kw)
        np.testing.assert_array_equal(keep[i], np.asarray(jkeep))
        np.testing.assert_array_equal(rank[i], np.asarray(jrank))
        v = valid[i]
        np.testing.assert_allclose(ns[i][v], np.asarray(jns)[v],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(ns[i][~v], np.float32(-1e30))
    # max_out really bound the selections
    assert keep.sum(1).max() == 25


@pytest.mark.parametrize("method,per_class", CASES)
def test_plain_matches_xla_soft_nms(method, per_class):
    import jax
    import jax.numpy as jnp
    from rrnet_tpu.ops import nms as jnms
    boxes, scores, cls, valid = dets(3, 120, seed=5)
    kw = dict(sigma=0.5, iou_threshold=0.3, score_threshold=0.1,
              method=method)
    ns, keep, rank = port(boxes, scores, valid, cls if per_class else None,
                          max_out=40, **kw)
    jfn = jax.vmap(lambda b, s, v, c: jnms.soft_nms(
        b, s, v, c if per_class else None, max_out=40, **kw))
    jns, jkeep, jrank = (np.asarray(a) for a in jfn(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
        jnp.asarray(cls)))
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(rank, jrank)
    np.testing.assert_allclose(ns[valid], jns[valid], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("method", ["gaussian", "linear", "hard"])
def test_plain_matches_numpy_oracle(method):
    from tests.oracles import np_soft_nms
    boxes, scores, _, _ = dets(1, 100, seed=0)
    ns, keep, rank = port(boxes, scores, sigma=0.5, iou_threshold=0.3,
                          score_threshold=0.05, method=method)
    order, oracle = np_soft_nms(boxes[0], scores[0], sigma=0.5,
                                iou_threshold=0.3, score_threshold=0.05,
                                method=method)
    got = np.where(keep[0])[0]
    np.testing.assert_array_equal(got[np.argsort(rank[0][got])], order)
    # the oracle computes IoU in float64 before rounding: 1e-4
    np.testing.assert_allclose(ns[0][got], oracle[got], rtol=1e-4, atol=1e-5)
    assert (rank[0][~keep[0]] == 100).all()


NAN_CASE_BOXES = np.array([[0, 0, 10, 10], [1, 0, 11, 10], [0, 0, 10, 10],
                           [50, 50, 60, 60]], np.float32)
NAN_CASE_CLASSES = np.array([0, 0, 0, 1], np.int32)
NAN_KW = dict(sigma=0.5, iou_threshold=0.3, score_threshold=0.001,
              method="gaussian")


@pytest.mark.parametrize("per_class", [False, True])
def test_nan_score_stops_the_serial_routes(per_class):
    """A fault of the JAX reference, pinned (ROADMAP C.14): one valid NaN
    score stops the serial soft-NMS before its first pick, so nothing is
    kept, class-agnostic or per class. The XLA route, the Pallas kernel
    (interpret mode) and the port's plain B.1 agree on it."""
    import jax.numpy as jnp
    from rrnet_tpu.ops import nms as jnms
    from rrnet_tpu.ops.pallas_nms import soft_nms_pallas
    scores = np.array([0.9, np.nan, 0.5, 0.4], np.float32)
    cls = NAN_CASE_CLASSES if per_class else None
    _, keep, rank = port(NAN_CASE_BOXES[None], scores[None], None,
                         None if cls is None else cls[None], **NAN_KW)
    jc = None if cls is None else jnp.asarray(cls)
    _, xkeep, _ = jnms.soft_nms(jnp.asarray(NAN_CASE_BOXES),
                                jnp.asarray(scores), None, jc, **NAN_KW)
    _, pkeep, _ = soft_nms_pallas(jnp.asarray(NAN_CASE_BOXES),
                                  jnp.asarray(scores), None, jc,
                                  per_class=per_class, interpret=True,
                                  **NAN_KW)
    assert keep[0].tolist() == [False] * 4
    assert np.asarray(xkeep).tolist() == np.asarray(pkeep).tolist() \
        == [False] * 4
    assert (rank[0] == 4).all()


def test_nan_coordinate_follows_the_pallas_route():
    """A fault of the JAX reference, pinned (ROADMAP C.15): with box 1's
    x1 NaN, JAX's XLA soft-NMS (its CPU route) makes that box's score NaN
    and keeps 1 of 4, while its Pallas kernel (the TPU route) keeps all 4
    ranked [0, 1, 3, 2]. The port follows the TPU route, bit for bit."""
    import jax.numpy as jnp
    from rrnet_tpu.ops import nms as jnms
    from rrnet_tpu.ops.pallas_nms import soft_nms_pallas
    boxes = NAN_CASE_BOXES.copy()
    boxes[1, 0] = np.nan
    scores = np.array([0.9, 0.8, 0.5, 0.4], np.float32)
    ns, keep, rank = port(boxes[None], scores[None], **NAN_KW)
    pns, pkeep, prank = (np.asarray(a) for a in soft_nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), interpret=True, **NAN_KW))
    xns, xkeep, xrank = (np.asarray(a) for a in jnms.soft_nms(
        jnp.asarray(boxes), jnp.asarray(scores), **NAN_KW))
    assert keep[0].tolist() == pkeep.tolist() == [True] * 4
    assert rank[0].tolist() == prank.tolist() == [0, 1, 3, 2]
    np.testing.assert_array_equal(ns[0], pns)
    assert xkeep.tolist() == [True, False, False, False]
    assert np.isnan(xns[1]) and xrank.tolist() == [0, 4, 4, 4]


def test_wrapper_rejects_non_cuda_devices():
    boxes, scores, _, _ = dets(1, 8, seed=1)
    with pytest.raises(ValueError):
        tsn.soft_nms(torch.from_numpy(boxes).to("meta"),
                     torch.from_numpy(scores).to("meta"))


def grid(b, k, identical):
    """k boxes an image: one per cell of a grid (no two overlap), or all
    the same box; scores falling with the index, so the picks go in index
    order."""
    cell = np.arange(k, dtype=np.float32)
    x = np.zeros(k, np.float32) if identical else (cell % 8) * 20.0
    y = np.zeros(k, np.float32) if identical else (cell // 8) * 20.0
    boxes = np.stack([x, y, x + 10.0, y + 10.0], -1)[None].repeat(b, 0)
    scores = np.linspace(0.9, 0.1, k, dtype=np.float32)[None].repeat(b, 0)
    return boxes, scores


@pytest.mark.parametrize("layout,per_class,max_out", [
    ("separated", False, None), ("separated", True, None),
    ("separated", False, 7), ("identical", False, None),
    ("identical", True, None)])
def test_work_counts_open_and_overlapping_slots(layout, per_class, max_out):
    """return_work: per image the open slots summed over the steps (every
    open slot takes the argmax and the overlap test) and the slots among
    them that overlap the pick (only they take the decay's arithmetic),
    counted on layouts where both are known: nothing drops below the
    threshold 0, so step s has n - s open slots; separated boxes never
    overlap; identical boxes all overlap, within their class when
    gated."""
    k = 20
    boxes, scores = grid(2, k, layout == "identical")
    valid = np.ones((2, k), bool)
    valid[1, ::5] = False                  # image 1: 16 valid boxes
    cls = np.tile(np.arange(k, dtype=np.int32) % 2, (2, 1))
    t = torch.from_numpy
    work = tsn.soft_nms_reference(
        t(boxes), t(scores), t(valid), t(cls) if per_class else None,
        sigma=0.5, score_threshold=0.0, max_out=max_out,
        return_work=True)[3]
    for i, n in enumerate(valid.sum(1)):
        steps = n if max_out is None else min(max_out, n)
        open_ = sum(n - s for s in range(steps))
        if layout == "separated":
            over = 0
        elif per_class:                    # n / 2 boxes of each class
            over = 2 * sum(range(n // 2))
        else:
            over = open_ - steps
        assert work[i].tolist() == [open_, over]


def edge_cases():
    """(name, boxes, scores, valid, cls, max_out, settings) the kernel must
    get right beside the main-path shape; `settings` override gaussian
    soft-NMS at sigma 0.5."""
    b, s, c, v = dets(4, 1500, seed=3, span=352.0, n_cls=10)
    ident = np.tile(np.array([[10, 10, 20, 20]], np.float32), (1, 64, 1))
    big_b, big_s, _, _ = dets(1, 4096, seed=4, span=352.0)
    signed = s[:, :600] - 0.3          # zero, -0 and negative scores
    signed[:, ::7] = 0.0
    signed[:, 3::11] = -0.0
    degen = b[:, :600].copy()          # x2 < x1 or y2 < y1
    flip = np.random.RandomState(5).rand(4, 600) < 0.33
    degen[flip] = degen[flip][:, [2, 3, 0, 1]]
    return [
        ("main", b, s, None, c, 512, {}),
        ("k1", b[:, :1], s[:, :1], None, c[:, :1], 512, {}),
        ("all_invalid", b[:, :40], s[:, :40], np.zeros((4, 40), bool),
         c[:, :40], 512, {}),
        ("identical", ident, np.linspace(1, .2, 64, dtype=np.float32)[None],
         None, None, 512, {}),
        ("equal_scores", b[:1, :300], np.full((1, 300), .5, np.float32),
         v[:1, :300], c[:1, :300], 512, {}),
        ("max_out_above", b[:, :200], s[:, :200], v[:, :200], c[:, :200],
         4000, {}),
        ("zero_negative_scores", b[:, :600], signed, None, c[:, :600], 512,
         {}),
        ("zero_negative_scores_agnostic", b[:, :600], signed, None, None, 512,
         {}),
        ("sigma_negative", b[:, :600], s[:, :600], None, c[:, :600], 512,
         dict(sigma=-0.5)),
        ("degenerate_boxes", degen, s[:, :600], v[:, :600], None, 512, {}),
        ("agnostic_k4096", big_b, big_s, None, None, 512, {}),
        ("agnostic_b1", b[:1], s[:1], None, None, 512, {}),
        ("max_out_37", b, s, None, c, 37, {}),
        ("max_out_3_agnostic", b, s, None, None, 3, {}),
        ("hard_negative_threshold", b[:, :600], s[:, :600], None, c[:, :600],
         512, dict(method="hard", iou_threshold=-0.1)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [e[0] for e in edge_cases()])
def test_cuda_kernel_matches_plain(cuda_device, case):
    name, boxes, scores, valid, cls, max_out, settings = next(
        e for e in edge_cases() if e[0] == case)
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device))
    args = (t(boxes), t(scores), t(valid), t(cls))
    kw = dict(dict(sigma=0.5, iou_threshold=0.7, score_threshold=0.1,
                   method="gaussian"), max_out=max_out, **settings)
    before = tsn.launches
    got = tsn.soft_nms(*args, **kw)
    torch.cuda.synchronize()
    assert tsn.launches == before + 1
    ref = tsn.soft_nms_reference(*args, **kw)
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2])
    k = ref[1]
    torch.testing.assert_close(got[0][k], ref[0][k], rtol=1e-5, atol=0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")
