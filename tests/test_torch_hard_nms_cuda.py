"""`csrc/hard_nms.cu` on the card against the plain fixpoint, bit for bit.

The kernel ranks, builds the pair mask and scans in one launch; its keep
mask must equal `ops.nms.hard_nms` (score order by `ops.nms.score_order`)
on every input: NaN, +-inf and +-0 scores, thresholds <= 0, B from 1 to 8,
K up to 4096, long suppression chains, and `hypothesis` draws of all of
them. A call launches one device kernel and ticks `launches` once, and
never synchronises the host. This module imports no JAX: it runs where
the card is, with

    python -m pytest --noconftest -m cuda tests/test_torch_hard_nms_cuda.py

and its tests skip on a machine without a CUDA device.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rrnet_torch.ops import hard_nms as thn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def detections(rng, b, k, n_cls=10, span=(192.0, 352.0)):
    """Boxes jittered around k/10 objects of a frame, so that many
    overlap; uniform scores; class ids."""
    n_obj = max(1, k // 10)
    centre = rng.rand(b, n_obj, 2) * np.array(span)
    which = rng.randint(0, n_obj, (b, k))
    c = np.take_along_axis(centre, which[..., None], 1)
    c = c + rng.randn(b, k, 2) * 2.0
    wh = rng.rand(b, k, 2) * 20.0 + 6.0
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.rand(b, k).astype(np.float32)
    cls = rng.randint(0, n_cls, (b, k)).astype(np.int32)
    return boxes, scores, cls


def chains(k, n=48):
    """In score order (scores fall with the index), the first n boxes of
    every 64 form a chain in which each suppresses the next at 0.5 (boxes
    10 px wide, 2 px apart: IoU 0.667 with the next, 0.43 with the one
    after); blocks lie 100 px apart, the other 64 - n boxes stand alone."""
    idx = np.arange(k)
    blk, pos = idx // 64, idx % 64
    x = np.where(pos < n, 2.0 * pos, 1000.0 + 20.0 * pos)
    y = 100.0 * blk
    boxes = np.stack([x, y, x + 10, y + 10], -1)[None].astype(np.float32)
    scores = np.linspace(1.0, 0.01, k, dtype=np.float32)[None]
    return boxes, scores


def cases():
    """(name, boxes, scores, valid, cls, thr, plus_one)."""
    rng = np.random.RandomState(3)
    b, s, c = detections(rng, 4, 1500)
    valid = rng.rand(4, 1500) < 0.8
    nan = s.copy()
    nan[:, ::7] = np.nan
    odd = s.copy()
    odd[:, ::5] = 0.0
    odd[:, 1::5] = -0.0
    odd[:, 2::11] = np.inf
    odd[:, 3::13] = -np.inf
    b1, s1, c1 = detections(rng, 1, 1500)
    b8, s8, c8 = detections(rng, 8, 1500)
    bk, sk, ck = detections(rng, 1, 4096, span=(400.0, 700.0))
    cb, cs = chains(1500)
    ident = np.tile(np.array([[[10, 10, 20, 20]]], np.float32), (2, 64, 1))
    # as a bf16 forward gives them: 8 bits of mantissa, many ties
    tied = torch.from_numpy(s).bfloat16().float().numpy()
    return [
        ("per_class", b, s, None, c, 0.7, False),
        ("agnostic", b, s, None, None, 0.7, False),
        ("valid_mask", b, s, valid, c, 0.7, False),
        ("plus_one", b, s, valid, None, 0.3, True),
        ("nan_valid_and_invalid", b, nan, valid, c, 0.7, False),
        ("nan_no_mask", b, nan, None, None, 0.5, False),
        ("signed_zeros_and_infs", b, odd, valid, c, 0.7, False),
        ("thr_0", b, s, valid, c, 0.0, False),
        ("thr_negative", b[:, :400], s[:, :400], valid[:, :400],
         c[:, :400], -0.1, False),
        ("thr_negative_plus_one", b[:, :200], s[:, :200], None, None, -0.1,
         True),
        ("b1_k1500", b1, s1, None, c1, 0.7, False),
        ("b8_k1500", b8, s8, None, c8, 0.7, False),
        ("k4096_b1", bk, sk, None, ck, 0.5, False),
        ("chain_of_48_every_64", cb, cs, None, None, 0.5, False),
        ("k1", b[:, :1], s[:, :1], None, c[:, :1], 0.7, False),
        ("all_invalid", b[:, :100], s[:, :100], np.zeros((4, 100), bool),
         c[:, :100], 0.7, False),
        ("identical", ident, np.full((2, 64), 0.3, np.float32), None, None,
         0.7, False),
        ("equal_scores", b[:, :300], np.full((4, 300), 0.5, np.float32),
         None, c[:, :300], 0.7, False),
        ("bf16_valued_scores", b, tied, valid, c, 0.7, False),
        ("bf16_valued_scores_b1", b[:1], tied[:1], None, None, 0.5, True),
        ("negative_scores", b, s - 0.5, valid, c, 0.7, False),
        ("k4096_one_score", bk, np.full((1, 4096), 0.25, np.float32), None,
         ck, 0.5, False),
    ]


NAMES = [c[0] for c in cases()]


def on(dev, *arrays):
    return [None if a is None else
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernel_bit_equal_plain(cuda_device, name):
    _, b, s, v, c, thr, plus_one = next(x for x in cases() if x[0] == name)
    boxes, scores, valid, cls = on(cuda_device, b, s, v, c)
    before = thn.launches
    got = thn.hard_nms(boxes, scores, thr, valid, cls, plus_one=plus_one)
    torch.cuda.synchronize()
    assert thn.launches == before + 1
    want = thn.hard_nms_reference(boxes, scores, thr, valid, cls,
                                  plus_one=plus_one)
    assert torch.equal(got, want)
    if name == "chain_of_48_every_64":
        kept = got[0].cpu().numpy()
        pos = np.arange(1500) % 64
        assert (kept == ((pos >= 48) | (pos % 2 == 0))).all()


@pytest.mark.cuda
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(bsz=st.integers(1, 8), k=st.integers(1, 4096),
       thr=st.sampled_from([-0.1, 0.0, 0.3, 0.5, 0.7]),
       per_class=st.booleans(), masked=st.booleans(),
       plus_one=st.booleans(), bf16=st.booleans(),
       seed=st.integers(0, 2 ** 31 - 1))
def test_kernel_bit_equal_plain_on_draws(cuda_device, bsz, k, thr, per_class,
                                         masked, plus_one, bf16, seed):
    """Random B, K, threshold, masks and scores drawn from a small pool
    (ties) with NaN, +-inf and +-0 in it, the others uniform or rounded
    to bf16."""
    rng = np.random.RandomState(seed)
    b, _, c = detections(rng, bsz, k, n_cls=4)
    pool = np.array([0.9, 0.5, 0.5, 0.3, 0.0, -0.0, np.nan, np.inf,
                     -np.inf, 0.7], np.float32)
    s = np.where(rng.rand(bsz, k) < 0.5, pool[rng.randint(0, 10, (bsz, k))],
                 rng.rand(bsz, k)).astype(np.float32)
    if bf16:
        s = torch.from_numpy(s).bfloat16().float().numpy()
    v = rng.rand(bsz, k) < 0.7 if masked else None
    boxes, scores, valid, cls = on(cuda_device, b, s, v,
                                   c if per_class else None)
    got = thn.hard_nms(boxes, scores, thr, valid, cls, plus_one=plus_one)
    want = thn.hard_nms_reference(boxes, scores, thr, valid, cls,
                                  plus_one=plus_one)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,k,per_class", [(4, 1500, True), (1, 1500, True),
                                             (4, 1000, False)])
def test_one_device_kernel_a_call(cuda_device, bsz, k, per_class):
    """torch.profiler sees one device kernel a call, the kernel's: no
    score mask, no sort, no scratch fill."""
    rng = np.random.RandomState(bsz * k)
    b, s, c = detections(rng, bsz, k)
    boxes, scores, cls = on(cuda_device, b, s, c if per_class else None)
    thn.hard_nms(boxes, scores, 0.7, None, cls)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            thn.hard_nms(boxes, scores, 0.7, None, cls)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3
    assert all("hard_nms_" in e.name for e in kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["b8_k1500", "plus_one",
                                  "nan_valid_and_invalid"])
def test_kernel_does_not_sync(cuda_device, name):
    _, b, s, v, c, thr, plus_one = next(x for x in cases() if x[0] == name)
    boxes, scores, valid, cls = on(cuda_device, b, s, v, c)
    thn.hard_nms(boxes, scores, thr, valid, cls, plus_one=plus_one)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keep = thn.hard_nms(boxes, scores, thr, valid, cls,
                            plus_one=plus_one)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(keep, thn.hard_nms_reference(
        boxes, scores, thr, valid, cls, plus_one=plus_one))
