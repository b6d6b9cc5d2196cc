"""Stage-1 soft-NMS: the wrappers of two CUDA kernels and their plain
PyTorch versions, and the dispatcher `soft_nms_auto`.

  * `soft_nms` wraps `csrc/soft_nms.cu`, the port of the serial Pallas
    kernel `rrnet_tpu/ops/pallas_nms.py::_make_kernel`; its plain version
    is `ops.nms.soft_nms` (`soft_nms_reference` here).
  * `soft_nms_classes` wraps `csrc/soft_nms_classes.cu`, the port of the
    class-parallel Pallas kernel `pallas_nms.py::_make_rows_kernel`; its
    plain version is `soft_nms_classes_reference`.

Each wrapper runs its plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, where it raises instead of
falling back. `launches` and `classes_launches` count the two kernels'
launches in this process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rrnet_torch.ops.nms import _METHODS, NEG
from rrnet_torch.ops.nms import soft_nms as soft_nms_reference
from rrnet_torch.utils import native

__all__ = ["soft_nms", "soft_nms_reference", "soft_nms_classes",
           "soft_nms_classes_reference", "soft_nms_auto", "launches",
           "classes_launches"]

launches = 0
classes_launches = 0

_kernel_and_max_k = None
_classes_kernel_and_limits = None


def _kernel():
    """The C entry of the kernel library and the largest K it takes."""
    global _kernel_and_max_k
    if _kernel_and_max_k is None:
        lib = native.load("soft_nms")
        fn = lib.rrnet_soft_nms
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel_and_max_k = fn, lib.rrnet_soft_nms_max_k()
    return _kernel_and_max_k


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, boxes on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             class_ids: Optional[torch.Tensor] = None, *,
             sigma: float = 0.5, iou_threshold: float = 0.3,
             score_threshold: float = 0.001, method: str = "gaussian",
             max_out: Optional[int] = None):
    """Batched soft-NMS: boxes (B, K, 4) xyxy f32, scores (B, K) f32,
    valid (B, K) bool or None, class_ids (B, K) int32 or None (None is
    class-agnostic). Returns (new_scores, keep, rank), each (B, K), as
    `ops.nms.soft_nms` defines them."""
    kw = dict(sigma=sigma, iou_threshold=iou_threshold,
              score_threshold=score_threshold, method=method,
              max_out=max_out)
    if boxes.device.type == "cpu":
        return soft_nms_reference(boxes, scores, valid, class_ids, **kw)
    if boxes.device.type != "cuda":
        raise ValueError(f"soft_nms runs on cpu or cuda, not {boxes.device}")

    bsz, k = scores.shape
    dev = boxes.device
    _check("boxes", boxes, torch.float32, (bsz, k, 4), dev)
    _check("scores", scores, torch.float32, (bsz, k), dev)
    if valid is not None:
        _check("valid", valid, torch.bool, (bsz, k), dev)
    if class_ids is not None:
        _check("class_ids", class_ids, torch.int32, (bsz, k), dev)
    if method not in _METHODS:
        raise ValueError(f"unknown soft-NMS method {method!r}")
    steps = k if max_out is None else min(max_out, k)

    new_scores = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    rank = torch.empty((bsz, k), dtype=torch.int32, device=dev)
    if bsz == 0:
        return new_scores, keep, rank
    fn, max_k = _kernel()
    if not 1 <= k <= max_k:
        raise ValueError(f"soft_nms kernel takes 1 <= K <= {max_k}, got {k}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 None if class_ids is None else class_ids.data_ptr(),
                 new_scores.data_ptr(), keep.data_ptr(), rank.data_ptr(),
                 bsz, k, max(steps, 0), _METHODS[method], sigma,
                 iou_threshold, score_threshold, stream)
    if err != 0:
        raise RuntimeError(f"soft_nms kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return new_scores, keep, rank


def _classes_kernel():
    """The C entry of the class-parallel kernel library, its largest K and
    its largest number of classes."""
    global _classes_kernel_and_limits
    if _classes_kernel_and_limits is None:
        lib = native.load("soft_nms_classes")
        fn = lib.rrnet_soft_nms_classes
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _classes_kernel_and_limits = (fn, lib.rrnet_soft_nms_classes_max_k(),
                                      lib.rrnet_soft_nms_classes_max_classes())
    return _classes_kernel_and_limits


def soft_nms_classes_reference(boxes: torch.Tensor, scores: torch.Tensor,
                               valid: Optional[torch.Tensor] = None,
                               class_ids: Optional[torch.Tensor] = None, *,
                               num_classes: int, sigma: float = 0.5,
                               iou_threshold: float = 0.3,
                               score_threshold: float = 0.001,
                               method: str = "gaussian",
                               max_out: Optional[int] = None,
                               return_work: bool = False):
    """Class-parallel per-class soft-NMS, the plain version of
    `soft_nms_classes` (the function of `rrnet_tpu/ops/pallas_nms.py::
    soft_nms_pallas_classes`, :330-423).

    Each image's valid boxes are laid out one row per class, in index
    order (invalid boxes take no row). Every class then advances one
    selection per step, with the arithmetic of `ops.nms.soft_nms`: pick
    the first open slot holding the row's max, mark it selected, decay the
    row's other open slots by w(IoU), deactivate those that overlap the
    pick and fell below score_threshold. Every class runs to exhaustion,
    so all of new_scores is a function of the inputs (non-kept boxes carry
    every decay of their class). The rank is then rebuilt as the position
    among selected boxes in (-score, index) order, and keep is the
    selected boxes of rank < min(max_out, K). Keep, kept scores and kept
    ranks equal the serial per-class `soft_nms`'s.

    boxes (B, K, 4) xyxy f32, scores (B, K) f32, valid (B, K) bool or
    None, class_ids (B, K) int (required) with the ids of valid boxes in
    [0, num_classes), or this raises. Returns (new_scores f32 with NEG for
    invalid slots, keep bool, rank int32 with K where not kept); with
    return_work also a (B, 2) int64 count summed over the steps, as the
    serial version counts it: the open slots (each class's argmax and
    overlap test touch its open slots only), and of those the slots that
    overlap their class's pick (they take the decay's arithmetic)."""
    if class_ids is None:
        raise ValueError("class-parallel soft-NMS is per class: class_ids "
                         "is required")
    bsz, k = scores.shape
    dev = scores.device
    method_id = _METHODS[method]
    steps = k if max_out is None else min(max_out, k)
    if valid is None:
        valid = torch.ones((bsz, k), dtype=torch.bool, device=dev)
    cls = class_ids.long()
    if bool((valid & ((cls < 0) | (cls >= num_classes))).any()):
        raise ValueError(f"class ids of valid boxes must lie in "
                         f"[0, {num_classes})")
    new_scores = torch.full((bsz, k), NEG, dtype=torch.float32, device=dev)
    keep = torch.zeros((bsz, k), dtype=torch.bool, device=dev)
    rank = torch.full((bsz, k), k, dtype=torch.int32, device=dev)
    work = torch.zeros((bsz, 2), dtype=torch.int64, device=dev)
    if bsz == 0 or k == 0:
        return (new_scores, keep, rank, work) if return_work else (
            new_scores, keep, rank)

    # partition: row (b, c) holds image b's valid boxes of class c, in
    # index order, at positions 0..n-1; invalid boxes go to row C, dropped
    c = num_classes
    key = torch.where(valid, cls, c)
    order = torch.sort(key, dim=1, stable=True).indices
    key_s = torch.gather(key, 1, order)
    counts = torch.zeros((bsz, c + 1), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, key, torch.ones_like(key))
    begin = torch.cumsum(counts, 1) - counts
    pos = torch.arange(k, device=dev) - torch.gather(begin, 1, key_s)
    kc = max(int(counts[:, :c].max()), 1)
    in_row = key_s < c
    slot = torch.where(in_row, key_s * kc + pos, c * kc)   # c*kc: a spare

    def rows(v_sorted, fill):
        out = torch.full((bsz, c * kc + 1), fill, dtype=v_sorted.dtype,
                         device=dev)
        out.scatter_(1, slot, v_sorted)
        return out[:, :c * kc].reshape(bsz, c, kc)

    def sorted_(v):
        return torch.gather(v, 1, order)

    x1, y1, x2, y2 = (rows(sorted_(v), 0.0) for v in boxes.float().unbind(-1))
    occupied = rows(in_row, False)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    cur = rows(sorted_(scores.float()), NEG)
    active = occupied.clone()
    selected = torch.zeros_like(occupied)
    idx = torch.arange(kc, device=dev)
    # a 0-dim tensor, so that the division is a true division on every
    # device (a scalar divisor may become a multiply by its reciprocal)
    sigma_t = torch.tensor(sigma, dtype=torch.float32, device=dev)

    def pick(v, m):
        return torch.gather(v, 2, m)              # (B, C, 1)

    while True:
        open_ = active & ~selected
        cand = torch.where(open_, cur, NEG)
        rmax = cand.max(dim=2, keepdim=True).values
        any_row = rmax > NEG                       # (B, C, 1)
        if not bool(any_row.any()):
            break
        if return_work:
            work[:, 0] += open_.sum((1, 2))
        first = torch.where(cand >= rmax, idx, kc).min(dim=2,
                                                       keepdim=True).values
        selected = selected | ((idx == first) & any_row)

        m = first.clamp(max=kc - 1)
        bx1, by1, bx2, by2 = pick(x1, m), pick(y1, m), pick(x2, m), pick(y2, m)
        barea = (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0)
        iw = torch.minimum(bx2, x2) - torch.maximum(bx1, x1) + 1.0
        ih = torch.minimum(by2, y2) - torch.maximum(by1, y1) + 1.0
        overlap_pos = (iw > 0.0) & (ih > 0.0) & any_row
        inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
        ov = inter / (barea + area - inter).clamp(min=1e-12)
        ov = torch.where(overlap_pos, ov, 0.0)
        if method_id == 1:
            wgt = torch.where(ov > iou_threshold, 1.0 - ov, 1.0)
        elif method_id == 2:
            wgt = torch.exp(-(ov * ov) / sigma_t)
        else:
            wgt = torch.where(ov > iou_threshold, 0.0, 1.0)

        decay = active & ~selected & any_row
        if return_work:
            work[:, 1] += (decay & overlap_pos).sum((1, 2))
        cur = torch.where(decay, cur * wgt, cur)
        active = active & ~(decay & overlap_pos & (cur < score_threshold))

    # back to the input order
    src = torch.where(in_row, key_s * kc + pos, 0)
    cur_s = torch.where(in_row, torch.gather(cur.reshape(bsz, -1), 1, src),
                        NEG)
    sel_s = in_row & torch.gather(selected.reshape(bsz, -1), 1, src)
    new_scores.scatter_(1, order, cur_s)
    sel = torch.zeros_like(keep).scatter_(1, order, sel_s)

    # rank: position among selected boxes in (-score, index) order
    sort_key = torch.where(sel, -new_scores, torch.inf)
    ord2 = torch.sort(sort_key, dim=1, stable=True).indices
    pos2 = torch.arange(k, device=dev).expand(bsz, k)
    rank_all = torch.empty_like(pos2).scatter_(1, ord2, pos2)
    keep = sel & (rank_all < steps)
    rank = torch.where(keep, rank_all, k).to(torch.int32)
    if return_work:
        return new_scores, keep, rank, work
    return new_scores, keep, rank


def soft_nms_classes(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: Optional[torch.Tensor] = None,
                     class_ids: Optional[torch.Tensor] = None, *,
                     num_classes: int, sigma: float = 0.5,
                     iou_threshold: float = 0.3,
                     score_threshold: float = 0.001,
                     method: str = "gaussian",
                     max_out: Optional[int] = None):
    """Batched class-parallel soft-NMS: boxes (B, K, 4) xyxy f32, scores
    (B, K) f32, valid (B, K) bool or None, class_ids (B, K) int32
    (required). Returns (new_scores, keep, rank), each (B, K), as
    `soft_nms_classes_reference` defines them. On a CUDA device the kernel
    treats valid boxes whose class id lies outside [0, num_classes) as
    invalid (the plain version raises on them)."""
    kw = dict(num_classes=num_classes, sigma=sigma,
              iou_threshold=iou_threshold, score_threshold=score_threshold,
              method=method, max_out=max_out)
    if class_ids is None:
        raise ValueError("class-parallel soft-NMS is per class: class_ids "
                         "is required")
    if boxes.device.type == "cpu":
        return soft_nms_classes_reference(boxes, scores, valid, class_ids,
                                          **kw)
    if boxes.device.type != "cuda":
        raise ValueError(f"soft_nms_classes runs on cpu or cuda, not "
                         f"{boxes.device}")

    bsz, k = scores.shape
    dev = boxes.device
    _check("boxes", boxes, torch.float32, (bsz, k, 4), dev)
    _check("scores", scores, torch.float32, (bsz, k), dev)
    if valid is not None:
        _check("valid", valid, torch.bool, (bsz, k), dev)
    _check("class_ids", class_ids, torch.int32, (bsz, k), dev)
    if method not in _METHODS:
        raise ValueError(f"unknown soft-NMS method {method!r}")
    steps = k if max_out is None else min(max_out, k)

    new_scores = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    rank = torch.empty((bsz, k), dtype=torch.int32, device=dev)
    if bsz == 0:
        return new_scores, keep, rank
    fn, max_k, max_classes = _classes_kernel()
    if not 1 <= k <= max_k:
        raise ValueError(f"soft_nms_classes kernel takes 1 <= K <= {max_k}, "
                         f"got {k}")
    if not 1 <= num_classes <= max_classes:
        raise ValueError(f"soft_nms_classes kernel takes 1 <= num_classes "
                         f"<= {max_classes}, got {num_classes}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 class_ids.data_ptr(), new_scores.data_ptr(),
                 keep.data_ptr(), rank.data_ptr(), bsz, k, num_classes,
                 max(steps, 0), _METHODS[method], sigma, iou_threshold,
                 score_threshold, stream)
    if err != 0:
        raise RuntimeError(f"soft_nms_classes kernel launch failed: CUDA "
                           f"error {err}")
    global classes_launches
    classes_launches += 1
    return new_scores, keep, rank


def soft_nms_auto(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  class_ids: Optional[torch.Tensor] = None,
                  num_classes: Optional[int] = None,
                  class_parallel: bool = False, **kw):
    """The soft-NMS dispatcher (`rrnet_tpu/ops/pallas_nms.py::
    soft_nms_auto`, :426-453): the class-parallel route only when asked
    for (`class_parallel`), per class (`per_class`, default: class_ids
    given) and with a static `num_classes`; the serial route otherwise,
    class-agnostic unless per class. A CPU tensor runs the plain version
    of the route taken. `kw` are the soft-NMS settings."""
    per_class = kw.pop("per_class", None)
    if per_class is None:
        per_class = class_ids is not None
    if (class_parallel and per_class and class_ids is not None
            and num_classes is not None):
        return soft_nms_classes(boxes, scores, valid, class_ids,
                                num_classes=num_classes, **kw)
    return soft_nms(boxes, scores, valid, class_ids if per_class else None,
                    **kw)
