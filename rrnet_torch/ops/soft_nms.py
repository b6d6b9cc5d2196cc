"""Stage-1 soft-NMS: the wrapper of the CUDA kernel `csrc/soft_nms.cu`
(the port of the serial Pallas kernel `rrnet_tpu/ops/pallas_nms.py::
_make_kernel`) and its plain PyTorch version.

`soft_nms` runs the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device, where it raises instead of
falling back. `launches` counts the kernel launches of this process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rrnet_torch.ops.nms import _METHODS
from rrnet_torch.ops.nms import soft_nms as soft_nms_reference
from rrnet_torch.utils import native

__all__ = ["soft_nms", "soft_nms_reference", "launches"]

launches = 0

_kernel_and_max_k = None


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
