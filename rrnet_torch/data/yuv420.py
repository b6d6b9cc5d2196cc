"""YUV 4:2:0 image transport (port of `rrnet_tpu/data/yuv420.py:33-160`).

The host packs uint8 RGB into planar I420 wire rows (Y plane, then the
2x2-subsampled U and V planes: 1.5 bytes a pixel, half of RGB's), and
the device rebuilds RGB. The convention is BT.601 studio swing (Y 16-235,
C 16-240) with chroma point-sampled at the top-left of each 2x2
(co-sited). The host side is the JAX package's numpy path: the port does
not depend on OpenCV.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def rgb_to_yuv420(rgb_u8: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 RGB -> (Y (B,H,W), UV (B,H/2,W/2,2)) uint8.
    H and W must be even."""
    f = rgb_u8.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    rs, gs, bs = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    cb = 128.0 - 0.148 * rs - 0.291 * gs + 0.439 * bs
    cr = 128.0 + 0.439 * rs - 0.368 * gs - 0.071 * bs
    y_u8 = np.clip(y + 0.5, 0, 255).astype(np.uint8)
    uv_u8 = np.clip(np.stack([cb, cr], -1) + 0.5, 0, 255).astype(np.uint8)
    return y_u8, uv_u8


def pack_yuv420(rgb_u8: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB -> (B, 1.5*H*W) uint8 planar-I420 rows;
    `out` (B, 1.5*H*W) stages in place."""
    bs, h, w = rgb_u8.shape[:3]
    if out is None:
        out = np.empty((bs, h * w * 3 // 2), np.uint8)
    y, uv = rgb_to_yuv420(rgb_u8)
    q = h * w // 4
    out[:, :h * w] = y.reshape(bs, -1)
    out[:, h * w:h * w + q] = uv[..., 0].reshape(bs, -1)
    out[:, h * w + q:] = uv[..., 1].reshape(bs, -1)
    return out


def _cosited_up2x(c: torch.Tensor, dim: int) -> torch.Tensor:
    """2x linear upsample along `dim` for co-sited samples: even outputs
    copy the sample, odd outputs average it with the next (edge
    clamped)."""
    n = c.shape[dim]
    nxt = torch.cat([c.narrow(dim, 1, n - 1), c.narrow(dim, n - 1, 1)], dim)
    pair = torch.stack([c, (c + nxt) * 0.5], dim=dim + 1)
    shape = list(c.shape)
    shape[dim] *= 2
    return pair.reshape(shape)


def yuv420_to_rgb_device(y_u8: torch.Tensor, uv_u8: torch.Tensor) -> torch.Tensor:
    """Inverse of rgb_to_yuv420 on the device: Y (B,H,W), UV
    (B,H/2,W/2,2) uint8 -> (B, H, W, 3) float RGB in [0, 255]."""
    y = (y_u8.float() - 16.0) * (255.0 / 219.0)
    uv = _cosited_up2x(_cosited_up2x(uv_u8.float(), 1), 2)
    cb = uv[..., 0] - 128.0
    cr = uv[..., 1] - 128.0
    rgb = torch.stack([y + 1.59602 * cr,
                       y - 0.39176 * cb - 0.81297 * cr,
                       y + 2.01723 * cb], dim=-1)
    return rgb.clamp(0.0, 255.0)


def unpack_yuv420_device(flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 1.5*h*w) uint8 planar-I420 rows -> (B, h, w, 3) float RGB in
    [0, 255]. Inverse of `pack_yuv420`."""
    n = flat.shape[0]
    q = h * w // 4
    y = flat[:, :h * w].reshape(n, h, w)
    u = flat[:, h * w:h * w + q].reshape(n, h // 2, w // 2)
    v = flat[:, h * w + q:].reshape(n, h // 2, w // 2)
    return yuv420_to_rgb_device(y, torch.stack([u, v], dim=-1))


def yuv420_to_rgb_host(y_u8: np.ndarray, uv_u8: np.ndarray) -> np.ndarray:
    """The device inverse in numpy (to look at packed train batches on the
    host): Y (B, H, W), UV (B, H/2, W/2, 2) uint8 -> (B, H, W, 3) uint8
    RGB."""
    y = (y_u8.astype(np.float32) - 16.0) * (255.0 / 219.0)
    uv = uv_u8.astype(np.float32)
    for axis in (1, 2):
        idx = np.minimum(np.arange(1, uv.shape[axis] + 1), uv.shape[axis] - 1)
        nxt = np.take(uv, idx, axis=axis)
        pair = np.stack([uv, (uv + nxt) * 0.5], axis=axis + 1)
        shape = list(uv.shape)
        shape[axis] *= 2
        uv = pair.reshape(shape)
    cb = uv[..., 0] - 128.0
    cr = uv[..., 1] - 128.0
    rgb = np.stack([y + 1.59602 * cr,
                    y - 0.39176 * cb - 0.81297 * cr,
                    y + 2.01723 * cb], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
