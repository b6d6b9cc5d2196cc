"""Seeded inputs: drone frames.

`frames` makes deterministic variants of the VisDrone demo frame kept in
`rrbench/data/` (a copy of the port's `data.synth` variant: a scaled
crop, a horizontal flip, objects copied and pasted elsewhere so the
layouts differ, a photometric gain and bias), resized to the traffic's
frame size. They depend on the seed alone.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

DATA = Path(__file__).resolve().parent / "data"


def demo() -> Tuple[np.ndarray, np.ndarray]:
    """The demo frame (H, W, 3) uint8 RGB and its (N, 8) annotations."""
    from PIL import Image
    with Image.open(DATA / "demo.jpg") as im:
        image = np.array(im.convert("RGB"))
    annos = np.loadtxt(DATA / "demo.txt", delimiter=",", ndmin=2)
    return image, annos.astype(np.float32)


def _resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    t = F.interpolate(t.float(), size=(oh, ow), mode="bilinear",
                      align_corners=False)
    return t[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def variant(image: np.ndarray, annos: np.ndarray, rng: np.random.Generator,
            out_hw: Tuple[int, int]) -> np.ndarray:
    """One variant of `image` at out_hw (the port's `data.synth._variant`
    on the pixels)."""
    h, w = image.shape[:2]
    oh, ow = out_hw
    s = float(rng.uniform(0.85, 1.35))
    src_h, src_w = min(h, int(round(oh / s))), min(w, int(round(ow / s)))
    y0 = int(rng.integers(0, h - src_h + 1))
    x0 = int(rng.integers(0, w - src_w + 1))
    img = _resize(image[y0:y0 + src_h, x0:x0 + src_w], oh, ow)
    boxes = annos[annos[:, 5] > 0, :4].copy()
    boxes[:, 0] = (boxes[:, 0] - x0) * ow / src_w
    boxes[:, 2] *= ow / src_w
    boxes[:, 1] = (boxes[:, 1] - y0) * oh / src_h
    boxes[:, 3] *= oh / src_h
    if rng.random() < 0.5:
        img = img[:, ::-1]
        boxes[:, 0] = ow - boxes[:, 0] - boxes[:, 2]
    img = np.ascontiguousarray(img)
    for _ in range(int(rng.integers(3, 9))):
        bx, by, bw, bh = (int(round(v)) for v in
                          boxes[int(rng.integers(0, len(boxes)))])
        if bw < 4 or bh < 4 or bx < 0 or by < 0 or bx + bw > ow \
                or by + bh > oh:
            continue
        patch = img[by:by + bh, bx:bx + bw].copy()
        px = int(rng.integers(0, ow - bw))
        py = int(np.clip(by + rng.integers(-40, 41), 0, oh - bh))
        img[py:py + bh, px:px + bw] = patch
    gain = rng.uniform(0.85, 1.15, 3).astype(np.float32)
    bias = rng.uniform(-12, 12, 3).astype(np.float32)
    return np.clip(img.astype(np.float32) * gain + bias, 0,
                   255).astype(np.uint8)


def frames(seed: int, count: int, hw: Tuple[int, int]) -> List[np.ndarray]:
    """`count` distinct frames of size hw from `seed`."""
    image, annos = demo()
    return [variant(image, annos, np.random.default_rng([seed, 7, i]), hw)
            for i in range(count)]

