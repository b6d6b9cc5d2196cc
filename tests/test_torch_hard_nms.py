"""The port's hard NMS (rrnet_torch.ops.hard_nms) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version (the fixpoint of
`rrnet_torch/ops/nms.py::hard_nms`), which is held to
`rrnet_tpu/ops/nms.py::hard_nms` under `jax.vmap` in both of its forms,
the XLA fixpoint and the literal sequential scan: the keep masks must be
equal (the IoU is the same f32 arithmetic, and the cases keep every pair
away from the threshold's rounding). Beside the random cases: a chain of
boxes where each suppresses the next (the fixpoint's deepest case), equal
scores, identical boxes, K=1, all invalid, a valid mask, class ids, and
`plus_one`. The CUDA kernel against the plain version (keep bit-equal)
runs only where a card is; the machine with the card has no JAX, so JAX is
imported inside the tests that use it, and there the CUDA cases run with

    python -m pytest --noconftest -m cuda tests/test_torch_hard_nms.py
"""

import numpy as np
import pytest
import torch

from rrnet_torch.ops import hard_nms as thn


def dets(b, k, seed, span=100.0, n_cls=4, p_valid=0.85):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, k, 2) * span
    wh = rng.rand(b, k, 2) * span * 0.3 + 1.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(b, k).astype(np.float32)
    cls = rng.randint(0, n_cls, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) < p_valid
    return boxes, scores, cls, valid


def chain(n=48):
    """Boxes 10 px wide, each 2 px right of the one before and scored
    lower: IoU 0.667 with its neighbour, 0.43 with the next but one, so at
    a 0.5 threshold each kept box suppresses only the next, and the greedy
    set is every second box, reached by the fixpoint after ~n iterations."""
    x = 2.0 * np.arange(n, dtype=np.float32)
    boxes = np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)], -1)
    scores = np.linspace(1.0, 0.1, n, dtype=np.float32)
    return boxes[None].astype(np.float32), scores[None]


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def cases():
    """(name, boxes, scores, valid, cls, iou_threshold, plus_one)."""
    b, s, c, v = dets(3, 120, seed=7)
    cb, cs = chain()
    ident = np.tile(np.array([[[10, 10, 20, 20]]], np.float32), (2, 50, 1))
    return [
        ("per_class", b, s, None, c, 0.5, False),
        ("agnostic", b, s, None, None, 0.5, False),
        ("valid_mask", b, s, v, c, 0.5, False),
        ("plus_one", b, s, v, None, 0.4, True),
        ("low_threshold", b, s, v, c, 0.1, False),
        ("chain", cb, cs, None, None, 0.5, False),
        ("equal_scores", b, np.full_like(s, 0.5), v, c, 0.5, False),
        ("identical", ident, np.full((2, 50), 0.3, np.float32), None, None,
         0.5, False),
        ("k1", b[:, :1], s[:, :1], None, c[:, :1], 0.5, False),
        ("all_invalid", b[:, :30], s[:, :30], np.zeros((3, 30), bool),
         c[:, :30], 0.5, False),
    ]


NAMES = [c[0] for c in cases()]


def case(name):
    return next(c for c in cases() if c[0] == name)[1:]


def jax_keep(boxes, scores, valid, cls, thr, plus_one, method):
    import jax
    import jax.numpy as jnp
    from rrnet_tpu.ops.nms import hard_nms
    if valid is None:
        valid = np.ones(scores.shape, bool)

    def one(b, s, v, c):
        return hard_nms(b, s, thr, valid=v, class_ids=c, plus_one=plus_one,
                        method=method)

    if cls is None:
        fn = jax.vmap(lambda b, s, v: one(b, s, v, None))
        return np.asarray(fn(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(valid)))
    return np.asarray(jax.vmap(one)(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), jnp.asarray(cls)))


@pytest.mark.parametrize("method", ["fixpoint", "sequential"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jax(name, method):
    boxes, scores, valid, cls, thr, plus_one = case(name)
    got = thn.hard_nms(t(boxes), t(scores), thr, t(valid), t(cls),
                       plus_one=plus_one).numpy()
    want = jax_keep(boxes, scores, valid, cls, thr, plus_one, method)
    np.testing.assert_array_equal(got, want)


def test_edge_cases_keep_the_greedy_set():
    _, _, valid, _, _, _ = case("chain")
    keep = thn.hard_nms(*(t(a) for a in case("chain")[:2]), 0.5).numpy()
    assert keep[0].tolist() == [i % 2 == 0 for i in range(48)]
    ib, isc, _, _, _, _ = case("identical")
    keep = thn.hard_nms(t(ib), t(isc), 0.5).numpy()
    # equal scores: the lowest index is kept, it suppresses the rest
    assert keep.sum(1).tolist() == [1, 1] and keep[:, 0].all()
    b, s, v, c, thr, _ = case("all_invalid")
    assert not thn.hard_nms(t(b), t(s), thr, t(v), t(c)).any()
    b, s, v, c, thr, _ = case("k1")
    assert thn.hard_nms(t(b), t(s), thr, t(v), t(c)).all()
    # class ids only gate: one class apart keeps at least as many
    b, s, v, c, thr, _ = case("per_class")
    per = thn.hard_nms(t(b), t(s), thr, None, t(c)).sum()
    agn = thn.hard_nms(t(b), t(s), thr).sum()
    assert per > agn


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    b, s, v, c, thr, plus_one = case("valid_mask")
    before = thn.launches
    got = thn.hard_nms(t(b), t(s), thr, t(v), t(c), plus_one=plus_one)
    want = thn.hard_nms_reference(t(b), t(s), thr, t(v), t(c),
                                  plus_one=plus_one)
    assert torch.equal(got, want) and got.dtype == torch.bool
    assert thn.launches == before


def test_wrapper_rejects_other_devices():
    b, s, _, _ = dets(1, 8, seed=1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        thn.hard_nms(t(b).to("meta"), t(s).to("meta"), 0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def cuda_cases():
    """The CPU cases, and the stage-1 candidate shape (B=4, K=1500, 10
    classes) per class and class-agnostic."""
    b, s, c, v = dets(4, 1500, seed=5, span=352.0, n_cls=10)
    return cases() + [
        ("main_per_class", b, s, None, c, 0.7, False),
        ("main_agnostic", b, s, v, None, 0.7, False),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES + ["main_per_class", "main_agnostic"])
def test_cuda_kernel_matches_plain(cuda_device, name):
    boxes, scores, valid, cls, thr, plus_one = next(
        c for c in cuda_cases() if c[0] == name)[1:]
    args = [None if a is None else t(a).to(cuda_device)
            for a in (boxes, scores, valid, cls)]
    before = thn.launches
    got = thn.hard_nms(args[0], args[1], thr, args[2], args[3],
                       plus_one=plus_one)
    torch.cuda.synchronize()
    assert thn.launches == before + 1
    want = thn.hard_nms_reference(args[0], args[1], thr, args[2], args[3],
                                  plus_one=plus_one)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_kernel_does_not_sync(cuda_device):
    b, s, c, _ = dets(2, 500, seed=9, span=352.0, n_cls=10)
    args = [t(a).to(cuda_device) for a in (b, s, c)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keep = thn.hard_nms(args[0], args[1], 0.7, None, args[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(keep, thn.hard_nms_reference(args[0], args[1], 0.7,
                                                    None, args[2]))


@pytest.mark.cuda
def test_cuda_batched_nms_launches_the_kernel(cuda_device):
    """`ops.nms.batched_nms` on the card goes through the kernel (one
    launch) and keeps what it keeps on the CPU."""
    from rrnet_torch.ops import nms as tnms
    b, s, c, v = dets(4, 1500, seed=11, span=352.0, n_cls=10)
    cpu = tnms.batched_nms(t(b), t(s), t(c), 0.7, valid=t(v))
    before = thn.launches
    got = tnms.batched_nms(*(t(a).to(cuda_device) for a in (b, s, c)), 0.7,
                           valid=t(v).to(cuda_device))
    torch.cuda.synchronize()
    assert thn.launches == before + 1
    assert torch.equal(got.cpu(), cpu)
