"""The epilogue of an eval convolution: the wrapper of the CUDA kernel
`csrc/conv_epilogue.cu` and its plain version, `conv_epilogue_reference`.

Given a convolution's raw output y (computed without its bias), one pass

    y = y + bias                                 (bias may be None)
    y = y + residual                             (residual may be None)
    y = relu(y)                                  (relu=True)

rounding after each add to the dtype PyTorch's eager ops give it (y's,
or f32 where a bf16 y takes an f32 residual, as stage 2's does), and the
ReLU as `F.relu` computes it on the card. That equals, bit for bit,
`F.relu(F.conv2d(x, w, b) + skip)`:
cuDNN's convolution adds its bias as a separate elementwise pass, which
the kernel takes over with the residual add and the ReLU. It replaces no
TPU kernel (XLA fused these into its convolution; the source says how it
meets its byte bound).

`conv_epilogue` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device (in place on y, but for
the mixed dtypes, which take a new f32 tensor), where it raises instead
of falling back: on a dtype other than bf16 and f32, on a y whose
channels are not its innermost axis, and on a residual not laid out as y
(`fits` says whether the kernel takes a y and a residual). `launches`
counts the kernel's launches in this process.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from rrnet_torch.utils import native

__all__ = ["conv_epilogue", "conv_epilogue_reference", "fits", "launches"]

launches = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_CL = torch.channels_last
_fn = None


def _kernel():
    """The C entry of the kernel library, its argument types set once:
    y, bias, residual and output pointers, n, C, y's dtype, the
    output's, relu and the stream."""
    global _fn
    if _fn is None:
        fn = native.load("conv_epilogue").rrnet_conv_epilogue
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv_epilogue_reference(y: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            residual: Optional[torch.Tensor] = None,
                            relu: bool = False) -> torch.Tensor:
    """The plain chain, op by op as the eager code wrote it: the bias
    add of a (1, C, 1, 1) tensor, the residual add, the ReLU. Returns a
    new tensor, or y itself where there is nothing to do."""
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def fits(y: torch.Tensor, residual: Optional[torch.Tensor] = None) -> bool:
    """Whether the kernel takes y (N, C, H, W), channels innermost and
    dense (channels-last memory), and the residual: None, or laid out
    as y, in y's dtype or, for a bf16 y, in f32."""
    return (y.is_contiguous(memory_format=_CL)
            and (residual is None
                 or (residual.shape == y.shape
                     and residual.stride() == y.stride()
                     and (residual.dtype == y.dtype
                          or (y.dtype == torch.bfloat16
                              and residual.dtype == torch.float32)))))


def conv_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  relu: bool = False) -> torch.Tensor:
    """The epilogue (module docstring) of the conv output y (N, C, H, W);
    bias (C,) in y's dtype, residual y's shape. On a CUDA device y is
    written in place and returned, or for a bf16 y with an f32 residual
    a new f32 tensor."""
    if y.device.type == "cpu":
        return conv_epilogue_reference(y, bias, residual, relu)
    if y.device.type != "cuda":
        raise ValueError(f"conv_epilogue runs on cpu or cuda, not "
                         f"{y.device}")
    kind = _DTYPES.get(y.dtype)
    if kind is None or y.dim() != 4:
        raise ValueError(f"conv_epilogue takes a 4-d bf16 or f32 tensor, "
                         f"got {y.dim()}-d {y.dtype}")
    if not fits(y, residual):
        raise ValueError(
            "conv_epilogue takes channels-last y and a residual of y's "
            "shape and strides, in y's dtype or (for a bf16 y) f32; got y "
            f"{tuple(y.shape)} {y.dtype} strides "
            f"{y.stride()}" + ("" if residual is None else
                               f", residual {tuple(residual.shape)} strides "
                               f"{residual.stride()} {residual.dtype}"))
    index = y.get_device()
    if residual is not None and residual.get_device() != index:
        raise ValueError(f"conv_epilogue: residual on {residual.device}, "
                         f"y on {y.device}")
    if bias is not None and (bias.dtype != y.dtype
                             or bias.get_device() != index
                             or bias.dim() != 1
                             or bias.shape[0] != y.shape[1]
                             or not bias.is_contiguous()):
        raise ValueError(f"conv_epilogue: bias must be a contiguous "
                         f"({y.shape[1]},) {y.dtype} tensor on {y.device}, "
                         f"got {tuple(bias.shape)} {bias.dtype} on "
                         f"{bias.device}")
    out = y
    if residual is not None and residual.dtype != y.dtype:
        out = torch.empty_like(y, dtype=residual.dtype)
    n = y.numel()
    if n == 0:
        return out
    args = (y.data_ptr(), None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(),
            n, y.shape[1], kind, _DTYPES[out.dtype], int(relu),
            torch._C._cuda_getCurrentRawStream(index))
    if torch.cuda.current_device() == index:
        err = _kernel()(*args)
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args)
    if err != 0:
        raise RuntimeError(f"conv_epilogue kernel launch failed: CUDA error "
                           f"{err}")
    global launches
    launches += 1
    return out
