"""RetinaNet anchors (a copy of `rrnet_tpu/models/anchors.py:1-66`):
numpy on the host, static per image shape and cached by it.

Pyramid levels (3, 4, 5) with strides 2^l, 3 ratios x 3 scales a cell,
cell centres at (i + 0.5) * stride, anchors emitted level-major, then
cell-major (row by row), then anchor-major within a cell, as (sum_l
H_l*W_l*A, 4) xyxy f32: the order of the detector's flattened outputs.
The RetinaNet operator overrides the sizes to (16, 64, 128) for
VisDrone's small objects (reference operators/retinanet_operator.py:30).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np


def generate_base_anchors(base_size: float,
                          ratios: Sequence[float] = (0.5, 1.0, 2.0),
                          scales: Sequence[float] = (1.0, 2 ** (1 / 3),
                                                     2 ** (2 / 3))
                          ) -> np.ndarray:
    """(A, 4) xyxy anchors centred at the origin, ratio-major (reference
    modules/anchor.py:39-69)."""
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    num = len(ratios) * len(scales)
    anchors = np.zeros((num, 4))
    # widths/heights before the ratio correction: base * scale, per ratio
    anchors[:, 2:] = base_size * np.tile(scales, (2, len(ratios))).T
    areas = anchors[:, 2] * anchors[:, 3]
    anchors[:, 2] = np.sqrt(areas / np.repeat(ratios, len(scales)))
    anchors[:, 3] = anchors[:, 2] * np.repeat(ratios, len(scales))
    anchors[:, 0::2] -= np.tile(anchors[:, 2] * 0.5, (2, 1)).T
    anchors[:, 1::2] -= np.tile(anchors[:, 3] * 0.5, (2, 1)).T
    return anchors.astype(np.float32)


@lru_cache(maxsize=64)
def anchors_for_shape(
    image_shape: Tuple[int, int],
    pyramid_levels: Tuple[int, ...] = (3, 4, 5),
    sizes: Tuple[float, ...] = (16, 64, 128),
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0),
    scales: Tuple[float, ...] = (1.0, 2 ** (1 / 3), 2 ** (2 / 3)),
) -> np.ndarray:
    """All anchors of an image shape -> (sum_l H_l*W_l*A, 4) xyxy f32.
    Level shapes use ceil division (modules/anchor.py:23). The cached
    array is shared by every caller: do not write to it."""
    h, w = image_shape
    out = []
    for lvl, size in zip(pyramid_levels, sizes):
        stride = 2 ** lvl
        fh = (h + stride - 1) // stride
        fw = (w + stride - 1) // stride
        base = generate_base_anchors(size, ratios, scales)        # (A, 4)
        sx = (np.arange(fw) + 0.5) * stride
        sy = (np.arange(fh) + 0.5) * stride
        sxx, syy = np.meshgrid(sx, sy)
        shifts = np.stack([sxx.ravel(), syy.ravel(),
                           sxx.ravel(), syy.ravel()], axis=1)    # (K, 4)
        out.append((base[None, :, :] + shifts[:, None, :]).reshape(-1, 4))
    anchors = np.concatenate(out, axis=0).astype(np.float32)
    anchors.flags.writeable = False
    return anchors


def model_anchors(model_cfg, image_shape: Tuple[int, int]) -> np.ndarray:
    """`anchors_for_shape` with a `config.ModelConfig`'s anchor fields."""
    m = model_cfg
    return anchors_for_shape(tuple(image_shape),
                             pyramid_levels=tuple(m.anchor_levels),
                             sizes=tuple(m.anchor_sizes),
                             ratios=tuple(m.anchor_ratios),
                             scales=tuple(m.anchor_scales))
