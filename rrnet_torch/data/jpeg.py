"""JPEG reading and writing (the PIL calls of `rrnet_tpu/data/visdrone.py`
and `rrnet_tpu/data/synth.py`).

PIL is installed where the port runs, with or without a card
(`chip_smoke.py`'s "device" phase prints what imports), so the port
decodes and encodes with PIL, as the JAX package does, and gets the same
pixels from the same files. PIL is
imported inside the functions, so importing this module loads nothing.
"""

from __future__ import annotations

import numpy as np


def decode(path: str) -> np.ndarray:
    """The image at `path` as (H, W, 3) uint8 RGB; a grayscale file comes
    back with its one channel repeated, as PIL's RGB conversion does."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def encode(path: str, img: np.ndarray, quality: int) -> None:
    """Write `img` ((H, W) gray or (H, W, 3) RGB uint8) as a JPEG of the
    given quality."""
    from PIL import Image
    Image.fromarray(np.ascontiguousarray(img)).save(path, quality=quality)
