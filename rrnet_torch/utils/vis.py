"""Detection drawing (port of `rrnet_tpu/utils/vis.py`; reference
utils/vis/annotations.py:8-59): boxes in a tab20 palette, optional
scores, and a strip of class names below the image.

OpenCV stays out of the port. `draw_rectangle` gives the pixels of
`cv2.rectangle(img, p1, p2, color, 1)` (8-connected, thickness 1): the
four edges of the box the two corners span, in either order, clipped to
the image. Text is drawn with PIL's default font (imported on use) where
the JAX package calls `cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.3, ...)`,
at the same baseline points, so its glyphs differ from OpenCV's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from rrnet_torch.data.visdrone import VISDRONE_CLASS_NAMES

# matplotlib's tab20 as RGB, written out so that matplotlib is not needed
TAB20 = np.asarray([
    (31, 119, 180), (174, 199, 232), (255, 127, 14), (255, 187, 120),
    (44, 160, 44), (152, 223, 138), (214, 39, 40), (255, 152, 150),
    (148, 103, 189), (197, 176, 213), (140, 86, 75), (196, 156, 148),
    (227, 119, 194), (247, 182, 210), (127, 127, 127), (199, 199, 199),
    (188, 189, 34), (219, 219, 141), (23, 190, 207), (158, 218, 229),
], np.uint8)
STRIP_ROWS = 14


def draw_rectangle(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int],
                   color) -> np.ndarray:
    """`cv2.rectangle(img, p1, p2, color, 1)` in place on an (H, W, C)
    array: rows y1 and y2 between x1 and x2, columns x1 and x2 between
    y1 and y2, ends included, clipped to the image. Returns img."""
    h, w = img.shape[:2]
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    x0, x1 = max(xa, 0), min(xb, w - 1)
    y0, y1 = max(ya, 0), min(yb, h - 1)
    if x0 <= x1:
        for y in (ya, yb):
            if 0 <= y < h:
                img[y, x0:x1 + 1] = color
    if y0 <= y1:
        for x in (xa, xb):
            if 0 <= x < w:
                img[y0:y1 + 1, x] = color
    return img


def _draw_text(img: np.ndarray, items) -> np.ndarray:
    """Draw (text, (x, baseline y), color) items with PIL's default font
    into a copy of img."""
    from PIL import Image, ImageDraw, ImageFont

    pil = Image.fromarray(img)
    draw = ImageDraw.Draw(pil)
    font = ImageFont.load_default()
    for text, xy, color in items:       # xy: the left end of the baseline
        draw.text(xy, text, fill=color, font=font, anchor="ls")
    return np.asarray(pil).copy()


def visualize(img: np.ndarray, annos: np.ndarray, xywh: bool = True,
              with_score: bool = False,
              class_names: Sequence[str] = VISDRONE_CLASS_NAMES
              ) -> np.ndarray:
    """Draw (N, >= 6) rows [x, y, w, h (or x2, y2), score, cls] on a copy
    of the uint8 (H, W, 3) image, then add the class-name strip below:
    (H + 14, W, 3)."""
    out = np.ascontiguousarray(np.array(img, copy=True))
    texts = []
    for row in np.asarray(annos):
        x, y = int(row[0]), int(row[1])
        if xywh:
            x2, y2 = int(row[0] + row[2]), int(row[1] + row[3])
        else:
            x2, y2 = int(row[2]), int(row[3])
        color = tuple(int(c) for c in TAB20[int(row[5]) % len(TAB20)])
        draw_rectangle(out, (x, y), (x2, y2), color)
        if with_score and len(row) > 4:
            texts.append((f"{row[4]:.2f}", (x, max(y - 2, 0)), color))
    if texts:
        out = _draw_text(out, texts)
    legend, x = [], 2
    for i, name in enumerate(class_names[:11]):
        legend.append((name, (x, 10),
                       tuple(int(c) for c in TAB20[i % len(TAB20)])))
        x += 8 * len(name)
        if x > out.shape[1] - 60:
            break
    strip = _draw_text(np.zeros((STRIP_ROWS, out.shape[1], 3), np.uint8),
                       legend)
    return np.concatenate([out, strip], axis=0)
