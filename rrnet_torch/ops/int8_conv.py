"""int8 post-training-quantized convolution: the wrappers of the CUDA
kernels in `csrc/int8_conv.cu` and their plain versions (port of the
int8 branch of `rrnet_tpu/models/layers.py::Conv2d`, :150-176).

The arithmetic, step by step as the JAX package does it:
  * activations per tensor: s_in = absmax / 127 (a Python double), each
    value rint(f32(x) * f32(1 / s_in)) (round half to even) clamped to
    [-127, 127] (`quantize_activation`);
  * weights per output channel: s_w = max(absmax over (cin, kh, kw),
    1e-12) / 127 in f32, each value rint(w / s_w) (an f32 division, not a
    multiply by the reciprocal) clamped to [-127, 127]
    (`quantize_weight`);
  * an exact int32 accumulation, then f32(acc) * (s_w * f32(s_in)), cast
    to the output dtype, then + bias in the output dtype.

Layouts. The quantized activation is NHWC int8 with its channels padded
with zeros to a multiple of 16 (`padded_channels`), so that 16 channels
of a tap are one aligned 16-byte load (`quantize_pack`). A weight is
quantized and packed once (`pack_weight` -> `PackedWeight`): the int8
OIHW weight, its rows in (ky, kx, c) order over the padded channels with
a zero tail to a multiple of 64 (the kernel's rows), and s_w.

`quantize_pack` and `int8_conv2d` run the plain version for tensors on
the CPU and launch the kernel for tensors on a CUDA device, where they
raise instead of falling back. `pack_launches` and `launches` count the
two kernels' launches in this process. The kernel takes groups 1,
dilation 1, any kernel size and stride and per-side padding
(`conv_geometry` checks a call against that contract). It walks output
tiles of TILE_M pixels x TILE_N channels in K steps of STEP_K bytes on a
persistent grid of one block an SM; `conv_schedule` decides how many
steps a unit of work takes (K is split where the tiles alone would leave
most SMs idle) and how many blocks run.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from rrnet_torch.utils import native

__all__ = ["PackedWeight", "Schedule", "conv_geometry", "conv_schedule",
           "int8_conv2d", "int8_conv2d_plain", "launches", "pack_launches",
           "pack_weight", "padded_channels", "quantize_activation",
           "quantize_pack", "quantize_pack_plain", "quantize_weight"]

launches = 0          # int8_conv2d kernel launches
pack_launches = 0     # quantize_pack kernel launches

CHANNEL_ALIGN = 16    # csrc/int8_conv.cu: rrnet_int8_channel_align()
K_ALIGN = 64          # csrc/int8_conv.cu: rrnet_int8_k_align()
TILE_M = 128          # rrnet_int8_tile_m(): output pixels a tile
TILE_N = 128          # rrnet_int8_tile_n(): output channels a tile
STEP_K = 128          # rrnet_int8_step_k(): K bytes a pipeline step
# a split unit takes at least this many K steps
MIN_SPLIT_STEPS = 2
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}

_fns = None
_sms = {}


def _kernels():
    """(quantize_pack, conv) C entries of the kernel library."""
    global _fns
    if _fns is None:
        lib = native.load("int8_conv")
        if ((lib.rrnet_int8_channel_align(), lib.rrnet_int8_k_align(),
             lib.rrnet_int8_tile_m(), lib.rrnet_int8_tile_n(),
             lib.rrnet_int8_step_k())
                != (CHANNEL_ALIGN, K_ALIGN, TILE_M, TILE_N, STEP_K)):
            raise RuntimeError("int8_conv library's alignments or tile "
                               "differ from ops/int8_conv.py's")
        qp = lib.rrnet_int8_quantize_pack
        qp.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_float,
                                               ctypes.c_void_p])
        qp.restype = ctypes.c_int
        conv = lib.rrnet_int8_conv
        conv.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 17 + [
            ctypes.c_void_p]
        conv.restype = ctypes.c_int
        _fns = qp, conv
    return _fns


def _sm_count(device: torch.device) -> int:
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


class Schedule(NamedTuple):
    """How the kernel walks one convolution: tiles_m x tiles_n output
    tiles, each in `splits` units of `split_steps` K steps (the last unit
    of a tile may take fewer) out of `steps`, on `grid` persistent blocks
    that take the `units` in turn."""
    tiles_m: int
    tiles_n: int
    steps: int
    split_steps: int
    splits: int
    units: int
    grid: int


def conv_schedule(m: int, cout: int, kp: int, sms: int) -> Schedule:
    """The schedule of a conv of m = N*Ho*Wo output pixels, `cout`
    channels and packed rows of kp bytes on a card of `sms` SMs. K is
    split only where the output tiles alone fill at most half of the SMs:
    then into as many units a tile as keep the units within one wave
    (sms), each at least MIN_SPLIT_STEPS steps. The grid is one block an
    SM, or one a unit where there are fewer units."""
    tiles_m = -(-m // TILE_M)
    tiles_n = -(-cout // TILE_N)
    steps = -(-kp // STEP_K)
    tiles = tiles_m * tiles_n
    splits = 1
    if 2 * tiles <= sms:
        splits = max(1, min(sms // tiles, steps // MIN_SPLIT_STEPS))
    split_steps = -(-steps // splits)
    splits = -(-steps // split_steps)
    units = tiles * splits
    return Schedule(tiles_m, tiles_n, steps, split_steps, splits, units,
                    min(units, sms))


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def _inv_scale(absmax: float) -> float:
    """f32(1 / s_in) as a Python float, s_in = absmax / 127 in double (the
    JAX package's Python floats; the product with an f32 array rounds
    the scalar to f32, as PyTorch's product with a Python scalar does)."""
    return float(torch.tensor(1.0 / (absmax / 127.0), dtype=torch.float32))


def dequant_scale(s_w: torch.Tensor, s_in: float) -> torch.Tensor:
    """The per-channel f32 dequantize multiplier s_w * f32(s_in) (an f32
    product; the Python scalar needs no copy to the device)."""
    return (s_w.float() * s_in).contiguous()


def quantize_activation(x: torch.Tensor, absmax: float) -> torch.Tensor:
    """x (any float dtype, as it arrives at the conv) -> int8 of the same
    shape: clip(round(f32(x) * f32(1 / s_in)), -127, 127)."""
    return torch.clamp(torch.round(x.float() * _inv_scale(absmax)),
                       -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW weight -> (int8 OIHW weight, s_w (cout,) f32)."""
    wf = w.float()
    s_w = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    wq = torch.clamp(torch.round(wf / s_w[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), s_w


class PackedWeight(NamedTuple):
    """A weight quantized once: the int8 OIHW weight (the plain
    version's), the kernel's (cout, Kp) rows and s_w (cout,) f32."""
    wq: torch.Tensor
    rows: torch.Tensor
    s_w: torch.Tensor


def pack_weight(w: torch.Tensor) -> PackedWeight:
    """Quantize an OIHW weight and lay its rows out for the kernel:
    (ky, kx, c) order over the padded channels, zero tail to K_ALIGN."""
    wq, s_w = quantize_weight(w)
    cout, cin, kh, kw = wq.shape
    cp = padded_channels(cin)
    rows = F.pad(wq.permute(0, 2, 3, 1), (0, cp - cin)).reshape(cout, -1)
    kp = -(-rows.shape[1] // K_ALIGN) * K_ALIGN
    rows = F.pad(rows, (0, kp - rows.shape[1])).contiguous()
    return PackedWeight(wq.contiguous(), rows, s_w.contiguous())


def quantize_pack_plain(x: torch.Tensor, absmax: float) -> torch.Tensor:
    """x (N, C, H, W) -> int8 (N, H, W, padded_channels(C)), zeros in the
    pad channels."""
    q = quantize_activation(x, absmax).permute(0, 2, 3, 1)
    return F.pad(q, (0, padded_channels(x.shape[1]) - x.shape[1])).contiguous()


def quantize_pack(x: torch.Tensor, absmax: float) -> torch.Tensor:
    """`quantize_pack_plain` on the CPU; the quantize-and-pack kernel on a
    CUDA tensor (f32 or bf16, NCHW contiguous)."""
    if x.device.type == "cpu":
        return quantize_pack_plain(x, absmax)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pack runs on cpu or cuda, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_pack takes f32 or bf16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("quantize_pack takes a contiguous (N, C, H, W) "
                         f"tensor, got shape {tuple(x.shape)}")
    if not absmax > 0:
        raise ValueError(f"quantize_pack needs absmax > 0, got {absmax}")
    n, c, h, w = x.shape
    cp = padded_channels(c)
    out = torch.empty((n, h, w, cp), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    qp = _kernels()[0]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = qp(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 out.data_ptr(), n, c, cp, h * w, _inv_scale(absmax), stream)
    if err != 0:
        raise RuntimeError(f"int8 quantize_pack kernel launch failed: CUDA "
                           f"error {err}")
    global pack_launches
    pack_launches += 1
    return out


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def out_size(h: int, w: int, kh: int, kw: int, stride, pad4
             ) -> Tuple[int, int]:
    sh, sw = _pair(stride)
    pt, pb, pl, pr = pad4
    return (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, s_w: torch.Tensor,
                      s_in: float, bias: Optional[torch.Tensor],
                      stride: Union[int, Sequence[int]],
                      pad4: Sequence[int], out_dtype: torch.dtype
                      ) -> torch.Tensor:
    """xq (N, H, W, Cp) int8 (the first cin channels used), wq (cout, cin,
    kh, kw) int8 -> (N, cout, Ho, Wo): the int32 accumulators for
    out_dtype int32, else f32(acc) * (s_w * f32(s_in)) cast to out_dtype,
    + bias in out_dtype. The accumulation is an f64 convolution, exact at
    these depths (|sum| < 127^2 * K < 2^53), rounded to int32."""
    cin = wq.shape[1]
    x = xq[..., :cin].permute(0, 3, 1, 2).double()
    pt, pb, pl, pr = pad4
    x = F.pad(x, (pl, pr, pt, pb))
    acc = torch.round(F.conv2d(x, wq.double(), stride=_pair(stride)))
    acc = acc.to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    y = (acc.float() * dequant_scale(s_w, s_in)[:, None, None]).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)[:, None, None]
    return y


def conv_geometry(xq: torch.Tensor, w: PackedWeight, stride, pad4
                  ) -> Tuple[int, int, int, int]:
    """(sh, sw, ho, wo) of the kernel's call on `quantize_pack`'s output
    `xq` with the packed weight `w`; raises ValueError where the call lies
    outside the kernel's contract: an input that is not a contiguous
    (N, H, W, Cp) int8 map with Cp the weight's channels padded to
    CHANNEL_ALIGN, rows that are not `pack_weight`'s (int8, (cout, Kp),
    Kp a multiple of K_ALIGN holding kh*kw*Cp, contiguous, 16-byte aligned
    for the weights' tensor map, on the input's device), a stride below 1,
    an empty output, or more than 2^31 - 1 input or output pixels (the
    kernel's pixel indices are 32-bit)."""
    cout, cin, kh, kw = w.wq.shape
    if xq.dtype != torch.int8 or xq.dim() != 4 or not xq.is_contiguous():
        raise ValueError("int8_conv2d takes a contiguous (N, H, W, Cp) int8 "
                         "input (quantize_pack's)")
    n, h, wd, cp = xq.shape
    if cp != padded_channels(cin):
        raise ValueError(f"input has {cp} channels, the weight {cin} "
                         f"(padded {padded_channels(cin)})")
    kp = w.rows.shape[1] if w.rows.dim() == 2 else -1
    if (w.rows.device != xq.device or w.rows.dtype != torch.int8
            or tuple(w.rows.shape) != (cout, kp) or kp % K_ALIGN
            or kp < kh * kw * cp or not w.rows.is_contiguous()
            or w.rows.data_ptr() % 16):
        raise ValueError("int8_conv2d needs pack_weight's rows on the "
                         "input's device")
    sh, sw = _pair(stride)
    ho, wo = out_size(h, wd, kh, kw, (sh, sw), pad4) if min(sh, sw) > 0 \
        else (0, 0)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output: {h}x{wd} input, {kh}x{kw} kernel, "
                         f"stride {(sh, sw)}, pad {pad4}")
    if max(n * h * wd, n * ho * wo) >= 2 ** 31:
        raise ValueError(f"int8_conv2d takes fewer than 2^31 input and "
                         f"output pixels, got {n}x{h}x{wd} -> {n}x{ho}x{wo}")
    return sh, sw, ho, wo


def int8_conv2d(xq: torch.Tensor, w: PackedWeight, s_in: float,
                bias: Optional[torch.Tensor] = None,
                stride: Union[int, Sequence[int]] = 1,
                pad4: Sequence[int] = (0, 0, 0, 0),
                out_dtype: torch.dtype = torch.bfloat16, *,
                groups: int = 1, dilation: int = 1,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 convolution of `quantize_pack`'s output with a packed
    weight: `int8_conv2d_plain` on the CPU, the implicit-GEMM kernel on a
    CUDA tensor. out_dtype f32, bf16, or int32 (the raw accumulators);
    bias (cout,) or None; `scale`, `dequant_scale(w.s_w, s_in)` made
    once by the caller, or None to make it here. Grouped and dilated
    convolutions are outside the kernel's contract and raise."""
    if groups != 1 or _pair(dilation) != (1, 1):
        raise ValueError(f"int8_conv2d takes groups 1 and dilation 1, got "
                         f"groups {groups}, dilation {dilation}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"int8_conv2d writes f32, bf16 or int32, not "
                        f"{out_dtype}")
    pad4 = tuple(int(p) for p in pad4)
    if len(pad4) != 4 or min(pad4) < 0:
        raise ValueError(f"pad4 is (top, bottom, left, right) >= 0, got "
                         f"{pad4}")
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, w.wq, w.s_w, s_in, bias, stride, pad4,
                                 out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv2d runs on cpu or cuda, not {xq.device}")
    sh, sw, ho, wo = conv_geometry(xq, w, stride, pad4)
    cout, _, kh, kw = w.wq.shape
    n, h, wd, cp = xq.shape
    kp = w.rows.shape[1]
    if n == 0:
        return torch.empty((n, cout, ho, wo), dtype=out_dtype,
                           device=xq.device)
    if out_dtype == torch.int32:
        scale = None
    elif scale is None:
        scale = dequant_scale(w.s_w, s_in)
    elif (tuple(scale.shape) != (cout,) or scale.dtype != torch.float32
          or scale.device != xq.device or not scale.is_contiguous()):
        raise ValueError(f"scale must be ({cout},) f32 on {xq.device}")
    if bias is not None and out_dtype != torch.int32:
        bias = bias.to(out_dtype).contiguous()
        if tuple(bias.shape) != (cout,) or bias.device != xq.device:
            raise ValueError(f"bias must be ({cout},) on {xq.device}")
    else:
        bias = None
    _, conv = _kernels()
    plan = conv_schedule(n * ho * wo, cout, kp, _sm_count(xq.device))
    # a conv whose K is split over units sums into a zeroed int32 map
    split = plan.splits > 1
    acc = None
    if split and out_dtype == torch.int32:
        out = torch.zeros((n, cout, ho, wo), dtype=out_dtype,
                          device=xq.device)
    else:
        out = torch.empty((n, cout, ho, wo), dtype=out_dtype,
                          device=xq.device)
        if split:
            acc = torch.zeros((n, cout, ho, wo), dtype=torch.int32,
                              device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = conv(xq.data_ptr(), w.rows.data_ptr(),
                   None if scale is None else scale.data_ptr(),
                   None if bias is None else bias.data_ptr(),
                   out.data_ptr(), None if acc is None else acc.data_ptr(),
                   _OUT_KIND[out_dtype], n, h, wd, cp, cout, kh, kw, sh, sw,
                   pad4[0], pad4[2], ho, wo, kp, plan.split_steps, plan.grid,
                   stream)
    if err != 0:
        raise RuntimeError(f"int8_conv2d kernel launch failed: CUDA error "
                           f"{err}" + (" (10000 + the driver's CUresult of "
                                       "the weights' tensor map)"
                                       if err >= 10000 else ""))
    global launches
    launches += 1
    return out
