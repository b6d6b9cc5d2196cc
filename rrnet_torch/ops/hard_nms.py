"""Stage-1 hard NMS: the wrapper of the CUDA kernel `csrc/hard_nms.cu`
and its plain version, `ops.nms.hard_nms` (`hard_nms_reference` here).

The JAX package runs hard NMS as an XLA fixpoint
(`rrnet_tpu/ops/nms.py::hard_nms`), not as a Pallas kernel; the plain
version iterates that fixpoint and checks convergence on the host once an
iteration. The kernel computes the fixpoint (the greedy keep set)
directly, score order included (`ops.nms.score_order`'s), in one launch
with no host round trip and no scratch, so a forward that takes it never
waits on the device.

`hard_nms` runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device, where it raises instead of falling
back. `launches` counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rrnet_torch.ops.nms import hard_nms as hard_nms_reference
from rrnet_torch.ops.soft_nms import _check
from rrnet_torch.utils import native

__all__ = ["hard_nms", "hard_nms_reference", "launches"]

launches = 0

_kernel_and_max_k = None
_set_up = set()


def bind(lib: ctypes.CDLL):
    """The C entry `rrnet_hard_nms` of a build of `csrc/hard_nms.cu`, its
    argument types set: boxes, scores, valid, class ids and keep pointers,
    B, K, the threshold, plus_one and the stream."""
    fn = lib.rrnet_hard_nms
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel(dev: torch.device):
    """The C entry of the kernel library and the largest K it takes; the
    kernel's attributes are set once for each device, before its first
    launch there."""
    global _kernel_and_max_k
    if _kernel_and_max_k is None:
        lib = native.load("hard_nms")
        _kernel_and_max_k = bind(lib), lib.rrnet_hard_nms_max_k(), lib
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _set_up:
        with torch.cuda.device(index):
            err = _kernel_and_max_k[2].rrnet_hard_nms_setup()
        if err != 0:
            raise RuntimeError(f"hard_nms kernel setup failed: CUDA error "
                               f"{err}")
        _set_up.add(index)
    return _kernel_and_max_k[:2]


def hard_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None,
             class_ids: Optional[torch.Tensor] = None,
             plus_one: bool = False) -> torch.Tensor:
    """Greedy hard NMS (suppress on iou > thr, gated to the same class when
    class_ids is given) over a batch of fixed-K box sets: boxes (B, K, 4)
    xyxy f32, scores (B, K) f32, valid (B, K) bool or None, class_ids
    (B, K) int32 or None. Returns the (B, K) bool keep mask, as
    `ops.nms.hard_nms` defines it."""
    if boxes.device.type == "cpu":
        return hard_nms_reference(boxes, scores, iou_threshold, valid,
                                  class_ids, plus_one)
    if boxes.device.type != "cuda":
        raise ValueError(f"hard_nms runs on cpu or cuda, not {boxes.device}")

    bsz, k = scores.shape
    dev = boxes.device
    _check("boxes", boxes, torch.float32, (bsz, k, 4), dev)
    _check("scores", scores, torch.float32, (bsz, k), dev)
    if valid is not None:
        _check("valid", valid, torch.bool, (bsz, k), dev)
    if class_ids is not None:
        _check("class_ids", class_ids, torch.int32, (bsz, k), dev)
    keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
    if bsz == 0:
        return keep
    fn, max_k = _kernel(dev)
    if not 1 <= k <= max_k:
        raise ValueError(f"hard_nms kernel takes 1 <= K <= {max_k}, got {k}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 None if class_ids is None else class_ids.data_ptr(),
                 keep.data_ptr(), bsz, k, iou_threshold, int(plus_one),
                 stream)
    if err != 0:
        raise RuntimeError(f"hard_nms kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return keep
