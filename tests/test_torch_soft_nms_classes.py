"""The port's class-parallel soft-NMS (rrnet_torch.ops.soft_nms.
soft_nms_classes) against the JAX package and against the port's serial
soft-NMS.

On the CPU the wrapper runs its plain version, which is held to
`rrnet_tpu/ops/pallas_nms.py::soft_nms_pallas_classes` in interpret mode
(keep and rank equal; all of new_scores within rtol 1e-5: the same f32
operations in the same order, so only XLA's own rounding can differ), and
to the port's serial plain soft-NMS by the contract of that function: the
same keep set, kept ranks and kept scores, bit for bit, and with no
max_out every score bit for bit (a decay across classes multiplies by
exactly 1.0). The CUDA kernel against the plain version (bit for bit)
and against the serial kernel runs only where a card is; the machine
with the card has no JAX, so JAX is imported inside the tests that use
it, and there the CUDA cases run with

    python -m pytest --noconftest -m cuda tests/test_torch_soft_nms_classes.py
"""

import numpy as np
import pytest
import torch

from rrnet_torch.ops import soft_nms as tsn
from torch_threads import one_torch_thread  # noqa: F401


def dets(b, k, seed, span=100.0, n_cls=4, p_valid=0.85):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, k, 2) * span
    wh = rng.rand(b, k, 2) * span * 0.3 + 1.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(b, k).astype(np.float32)
    cls = rng.randint(0, n_cls, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) < p_valid
    return boxes, scores, cls, valid


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def plain(boxes, scores, valid, cls, **kw):
    return [o.numpy() for o in tsn.soft_nms_classes_reference(
        t(boxes), t(scores), t(valid), t(cls), **kw)]


CASES = [(m, mo, masked) for m in ("gaussian", "linear", "hard")
         for mo in (None, 25) for masked in (True, False)]


@pytest.mark.parametrize("method,max_out,masked", CASES)
def test_plain_matches_pallas_classes_interpret(method, max_out, masked):
    import jax.numpy as jnp
    from rrnet_tpu.ops.pallas_nms import soft_nms_pallas_classes
    boxes, scores, cls, valid = dets(2, 160, seed=7)
    valid = valid if masked else None
    kw = dict(num_classes=4, sigma=0.5, iou_threshold=0.3,
              score_threshold=0.2, method=method, max_out=max_out)
    ns, keep, rank = plain(boxes, scores, valid, cls, **kw)
    for i in range(2):
        jns, jkeep, jrank = soft_nms_pallas_classes(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            None if valid is None else jnp.asarray(valid[i]),
            jnp.asarray(cls[i]), interpret=True, **kw)
        np.testing.assert_array_equal(keep[i], np.asarray(jkeep))
        np.testing.assert_array_equal(rank[i], np.asarray(jrank))
        np.testing.assert_allclose(ns[i], np.asarray(jns), rtol=1e-5,
                                   atol=0)
    if max_out is not None:     # max_out really bound the selections
        assert keep.sum(1).max() == max_out


@pytest.mark.parametrize("method,max_out,masked", CASES)
def test_plain_matches_serial_plain_by_contract(method, max_out, masked):
    boxes, scores, cls, valid = dets(3, 300, seed=11, n_cls=6)
    valid = valid if masked else None
    kw = dict(sigma=0.5, iou_threshold=0.3, score_threshold=0.2,
              method=method, max_out=max_out)
    ns, keep, rank = tsn.soft_nms_classes_reference(
        t(boxes), t(scores), t(valid), t(cls), num_classes=6, **kw)
    sns, skeep, srank = tsn.soft_nms_reference(
        t(boxes), t(scores), t(valid), t(cls), **kw)
    assert torch.equal(keep, skeep)
    assert torch.equal(rank, srank)
    assert torch.equal(ns[keep], sns[skeep])
    if max_out is None:
        assert torch.equal(ns, sns)


def test_work_counts_open_slots_of_each_class():
    """return_work: the open slots summed over the steps of each class,
    and the overlapping ones among them; one class alone gives the serial
    version's counts."""
    boxes, scores, _, _ = dets(2, 120, seed=3)
    one = np.zeros((2, 120), np.int32)
    kw = dict(sigma=0.5, iou_threshold=0.3, score_threshold=0.2)
    work = tsn.soft_nms_classes_reference(
        t(boxes), t(scores), None, t(one), num_classes=3, return_work=True,
        **kw)[3]
    swork = tsn.soft_nms_reference(t(boxes), t(scores), None, t(one),
                                   return_work=True, **kw)[3]
    # the serial loop also counts 0 for the steps after exhaustion
    assert torch.equal(work, swork)
    assert (work[:, 0] > 120).all()
    assert ((work[:, 1] > 0) & (work[:, 1] < work[:, 0])).all()


def edge_cases():
    """(name, boxes, scores, valid, cls, num_classes, max_out, method)
    beside the stage-1 candidate shape (B=4, K=1500, 10 classes)."""
    b, s, c, v = dets(4, 1500, seed=5, span=352.0, n_cls=10)
    return [
        ("main", b, s, None, c, 10, 512, "gaussian"),
        ("k1", b[:, :1], s[:, :1], None, c[:, :1], 10, 512, "gaussian"),
        ("all_invalid", b[:, :40], s[:, :40], np.zeros((4, 40), bool),
         c[:, :40], 10, 512, "gaussian"),
        ("one_class", b[:, :300], s[:, :300], None,
         np.full((4, 300), 3, np.int32), 10, 512, "gaussian"),
        ("equal_scores", b[:1, :300], np.full((1, 300), .5, np.float32),
         v[:1, :300], c[:1, :300], 10, 512, "gaussian"),
        ("max_out_above", b[:, :200], s[:, :200], v[:, :200], c[:, :200],
         10, 4000, "gaussian"),
        ("more_classes_than_present", b[:, :200], s[:, :200], None,
         c[:, :200] % 3, 16, 512, "gaussian"),
        ("linear", b, s, v, c, 10, 512, "linear"),
        ("hard", b, s, v, c, 10, 512, "hard"),
        ("valid_mask", b, s, v, c, 10, 512, "gaussian"),
    ]


EDGE = [e[0] for e in edge_cases()]


@pytest.mark.parametrize("case", EDGE)
def test_plain_edge_cases_against_serial_plain(case):
    _, boxes, scores, valid, cls, n_cls, max_out, method = next(
        e for e in edge_cases() if e[0] == case)
    if case == "main":      # the full shape runs on the card
        boxes, scores, cls = boxes[:1, :400], scores[:1, :400], cls[:1, :400]
    kw = dict(sigma=0.5, iou_threshold=0.7, score_threshold=0.1,
              method=method, max_out=max_out)
    ns, keep, rank = tsn.soft_nms_classes_reference(
        t(boxes), t(scores), t(valid), t(cls), num_classes=n_cls, **kw)
    sns, skeep, srank = tsn.soft_nms_reference(
        t(boxes), t(scores), t(valid), t(cls), **kw)
    assert torch.equal(keep, skeep) and torch.equal(rank, srank)
    assert torch.equal(ns[keep], sns[skeep])
    if valid is not None:
        assert (ns[~t(valid)] == np.float32(-1e30)).all()
    if case == "all_invalid":
        assert not keep.any() and (rank == 40).all()


def test_dispatch_follows_soft_nms_auto(monkeypatch):
    """class_parallel only with per-class ids and num_classes; per_class=
    False is class-agnostic (rrnet_tpu/ops/pallas_nms.py:445-451)."""
    calls = []
    monkeypatch.setattr(tsn, "soft_nms", lambda b, s, v, c, **kw:
                        calls.append(("serial", c is None)))
    monkeypatch.setattr(tsn, "soft_nms_classes", lambda b, s, v, c, **kw:
                        calls.append(("classes", kw["num_classes"])))
    boxes, scores, cls, _ = dets(1, 8, seed=1)
    a = (t(boxes), t(scores))
    tsn.soft_nms_auto(*a, class_ids=t(cls), num_classes=4,
                      class_parallel=True, max_out=3)
    tsn.soft_nms_auto(*a, class_ids=t(cls), num_classes=4)
    tsn.soft_nms_auto(*a, class_ids=t(cls), class_parallel=True)
    tsn.soft_nms_auto(*a, class_ids=t(cls), num_classes=4,
                      class_parallel=True, per_class=False)
    tsn.soft_nms_auto(*a, num_classes=4, class_parallel=True)
    assert calls == [("classes", 4), ("serial", False), ("serial", False),
                     ("serial", True), ("serial", True)]


def test_cpu_routes_run_the_plain_versions():
    boxes, scores, cls, valid = dets(2, 60, seed=2)
    args = (t(boxes), t(scores), t(valid), t(cls))
    kw = dict(sigma=0.5, iou_threshold=0.3, score_threshold=0.2, max_out=9)
    before = (tsn.launches, tsn.classes_launches)
    got = tsn.soft_nms_auto(*args, num_classes=4, class_parallel=True, **kw)
    want = tsn.soft_nms_classes_reference(*args, num_classes=4, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tsn.launches, tsn.classes_launches) == before


def test_refusals():
    boxes, scores, cls, valid = dets(1, 12, seed=4)
    with pytest.raises(ValueError, match="class_ids is required"):
        tsn.soft_nms_classes(t(boxes), t(scores), num_classes=4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tsn.soft_nms_classes(t(boxes).to("meta"), t(scores).to("meta"),
                             class_ids=t(cls).to("meta"), num_classes=4)
    bad = cls.copy()
    bad[0, 3] = 4                       # == num_classes, and valid
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        tsn.soft_nms_classes(t(boxes), t(scores), None, t(bad),
                             num_classes=4)
    bad[0, 3] = -1
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        tsn.soft_nms_classes_reference(t(boxes), t(scores), None, t(bad),
                                       num_classes=4)
    # an out-of-range id on an invalid box is not looked at
    inv = np.ones((1, 12), bool)
    inv[0, 3] = False
    bad[0, 3] = 99
    tsn.soft_nms_classes(t(boxes), t(scores), t(inv), t(bad), num_classes=4)


def test_jax_partition_mishandles_out_of_range_ids():
    """A fault of the JAX reference (ROADMAP C): with num_classes=10 its
    partition gives the ids 10-15 rows of their own, so such a box is
    kept as if of an 11th class, and it drops ids of 16 and above with a
    NaN score. The port's plain version raises on both; its kernel treats
    both as invalid (test_cuda_kernel_refusals_and_out_of_range_ids)."""
    import jax.numpy as jnp
    from rrnet_tpu.ops.pallas_nms import soft_nms_pallas_classes
    boxes = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 50, 50],
                      [60, 60, 70, 70]], np.float32)
    scores = np.array([.9, .8, .7, .6], np.float32)
    cls = np.array([0, 12, 17, 3], np.int32)
    ns, keep, _ = soft_nms_pallas_classes(
        jnp.asarray(boxes), jnp.asarray(scores), None, jnp.asarray(cls),
        num_classes=10, interpret=True)
    assert np.asarray(keep).tolist() == [True, True, False, True]
    assert np.isnan(np.asarray(ns)[2])
    for c in (12, 17):
        with pytest.raises(ValueError, match=r"\[0, 10\)"):
            tsn.soft_nms_classes(t(boxes[None]), t(scores[None]), None,
                                 t(np.array([[0, c, 1, 3]], np.int32)),
                                 num_classes=10)


def test_empty_batch_and_zero_k():
    for shape in ((0, 5), (2, 0)):
        b = torch.zeros(shape + (4,))
        s = torch.zeros(shape)
        c = torch.zeros(shape, dtype=torch.int32)
        ns, keep, rank = tsn.soft_nms_classes_reference(b, s, None, c,
                                                        num_classes=3)
        assert ns.shape == keep.shape == rank.shape == shape


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE)
def test_cuda_kernel_matches_plain_and_serial_kernel(cuda_device, case):
    _, boxes, scores, valid, cls, n_cls, max_out, method = next(
        e for e in edge_cases() if e[0] == case)
    td = (lambda a: None if a is None else t(a).to(cuda_device))
    args = (td(boxes), td(scores), td(valid), td(cls))
    kw = dict(sigma=0.5, iou_threshold=0.7, score_threshold=0.1,
              method=method, max_out=max_out)
    before = tsn.classes_launches
    got = tsn.soft_nms_classes(*args, num_classes=n_cls, **kw)
    torch.cuda.synchronize()
    assert tsn.classes_launches == before + 1
    ref = tsn.soft_nms_classes_reference(*args, num_classes=n_cls, **kw)
    for g, r in zip(got, ref):          # bit for bit
        assert torch.equal(g, r)
    ser = tsn.soft_nms(*args, **kw)
    assert torch.equal(got[1], ser[1]) and torch.equal(got[2], ser[2])
    assert torch.equal(got[0][got[1]], ser[0][ser[1]])


@pytest.mark.cuda
def test_cuda_kernel_refusals_and_out_of_range_ids(cuda_device):
    boxes, scores, cls, _ = dets(2, 50, seed=6)
    td = (lambda a: t(a).to(cuda_device))
    with pytest.raises(TypeError):
        tsn.soft_nms_classes(td(boxes).double(), td(scores),
                             class_ids=td(cls), num_classes=4)
    with pytest.raises(ValueError, match="K <="):
        big = np.zeros((1, 5000, 4), np.float32)
        tsn.soft_nms_classes(td(big), td(np.zeros((1, 5000), np.float32)),
                             class_ids=td(np.zeros((1, 5000), np.int32)),
                             num_classes=4)
    # valid boxes with ids outside [0, C) are treated as invalid
    bad = cls.copy()
    bad[:, ::5] = 7
    got = tsn.soft_nms_classes(td(boxes), td(scores), class_ids=td(bad),
                               num_classes=4, max_out=20)
    torch.cuda.synchronize()
    valid = bad < 4
    want = tsn.soft_nms_classes_reference(
        td(boxes), td(scores), td(valid), td(np.where(valid, bad, 0)),
        num_classes=4, max_out=20)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
