"""Deterministic synthetic VisDrone-format dataset from the demo fixture
(port of `rrnet_tpu/data/synth.py`: the same seeds and random stream
give the same annotations and the same pixels; JPEGs are written
through `data.jpeg` at the same qualities, 92 and 95, and the resize is
the numpy copy of `cv2.resize` in `data.transforms`).

VisDrone itself is not shippable with the repo, so the end-to-end
train->eval->AP regression gate (scripts/synth_gate.py, SYNTH_AP.json)
runs on a generated multi-image dataset instead: each image is a
deterministic geometric + photometric variant of the in-tree demo image
(`data/demo/`, the reference's own fixture), with its 86 annotations
transformed accordingly, plus extra copy-pasted objects so layouts
differ between images. A roadmap band is synthesized from the vehicle
rows so the FillDuck-with-roadmap augmentation path
(reference datasets/transforms/functional.py:356-524) is exercised
during training.

Determinism: everything derives from numpy Generators seeded from
(seed, image index); JPEGs are written at a fixed quality, so a given
(seed, n_train, n_val) always produces byte-identical datasets and the
gate's AP is comparable across rounds.

Layout written (the reference's folder contract, datasets/drones_det.py:18-20):
    {out_dir}/train/{images,annotations,roadmap}
    {out_dir}/val/{images,annotations}
"""

from __future__ import annotations

import os
import shutil
import zlib
from typing import Optional, Tuple

import numpy as np

from rrnet_torch.data import jpeg
from rrnet_torch.data.transforms import _resize_image
from rrnet_torch.data.visdrone import VisDroneDataset, parse_annotation_file

VEHICLE_CLASSES = (4, 5, 6, 9)   # car, van, truck, bus


def _variant(image: np.ndarray, annos: np.ndarray,
             rng: np.random.Generator,
             out_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """One deterministic variant: scaled crop + hflip + photometric
    jitter + object copy-paste; annos follow every transform."""
    h, w = image.shape[:2]
    oh, ow = out_hw

    # ---- scaled crop: pick a window of (oh, ow)/s source pixels -------
    s = float(rng.uniform(0.85, 1.35))
    src_h = min(h, int(round(oh / s)))
    src_w = min(w, int(round(ow / s)))
    y0 = int(rng.integers(0, h - src_h + 1))
    x0 = int(rng.integers(0, w - src_w + 1))
    crop = image[y0:y0 + src_h, x0:x0 + src_w]

    a = annos.copy()
    a[:, 0] -= x0
    a[:, 1] -= y0
    # keep boxes with >= 60% of their area inside the crop
    x1 = np.clip(a[:, 0], 0, src_w)
    y1 = np.clip(a[:, 1], 0, src_h)
    x2 = np.clip(a[:, 0] + a[:, 2], 0, src_w)
    y2 = np.clip(a[:, 1] + a[:, 3], 0, src_h)
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep = inter >= 0.6 * a[:, 2] * a[:, 3]
    a = a[keep]
    a[:, 0] = x1[keep]
    a[:, 1] = y1[keep]
    a[:, 2] = (x2 - x1)[keep]
    a[:, 3] = (y2 - y1)[keep]

    # ---- resize to the canonical output size ---------------------------
    sy, sx = oh / src_h, ow / src_w
    img = _resize_image(crop, (ow, oh))
    a[:, 0] *= sx
    a[:, 2] *= sx
    a[:, 1] *= sy
    a[:, 3] *= sy

    # ---- horizontal flip -----------------------------------------------
    if rng.random() < 0.5:
        img = img[:, ::-1]
        a[:, 0] = ow - a[:, 0] - a[:, 2]

    # ---- copy-paste a few objects so layouts differ between images ----
    n_paste = int(rng.integers(3, 9))
    boxes = a[a[:, 5] > 0]
    rows = []
    img = np.ascontiguousarray(img)
    for _ in range(n_paste):
        if not len(boxes):
            break
        src = boxes[int(rng.integers(0, len(boxes)))]
        bw, bh = int(round(src[2])), int(round(src[3]))
        bx, by = int(round(src[0])), int(round(src[1]))
        if bw < 4 or bh < 4 or bx < 0 or by < 0 \
                or bx + bw > ow or by + bh > oh:
            continue
        patch = img[by:by + bh, bx:bx + bw].copy()
        px = int(rng.integers(0, ow - bw))
        # paste at a similar depth (y-band) so apparent size stays sane
        py = int(np.clip(by + rng.integers(-40, 41), 0, oh - bh))
        img[py:py + bh, px:px + bw] = patch
        rows.append([px, py, bw, bh, 1, src[5], 0, 0])
    if rows:
        a = np.concatenate([a, np.asarray(rows, np.float32)], axis=0)

    # ---- photometric jitter --------------------------------------------
    gain = rng.uniform(0.85, 1.15, 3)
    bias = rng.uniform(-12, 12, 3)
    img = np.clip(img.astype(np.float32) * gain + bias, 0, 255)
    return img.astype(np.uint8), a


def _roadmap_from_annos(annos: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Road band = dilated union of vehicle box rows (uint8 0/255).
    Gives fill_duck plausible paste coordinates without a real
    segmentation map."""
    h, w = hw
    rm = np.zeros((h, w), np.uint8)
    veh = annos[np.isin(annos[:, 5].astype(int), VEHICLE_CLASSES)]
    for x, y, bw, bh in veh[:, :4]:
        y1 = int(max(0, y - 0.5 * bh))
        y2 = int(min(h, y + 1.5 * bh))
        rm[y1:y2, :] = 255
    if not rm.any():
        rm[h // 2:h // 2 + max(h // 8, 8), :] = 255
    return rm


def _write_split(ds_dir: str, split: str, count: int, image, annos,
                 sizes, seed: int, with_roadmap: bool):
    img_dir = os.path.join(ds_dir, split, "images")
    ann_dir = os.path.join(ds_dir, split, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    if with_roadmap:
        rm_dir = os.path.join(ds_dir, split, "roadmap")
        os.makedirs(rm_dir, exist_ok=True)

    split_key = zlib.crc32(split.encode())   # str hash() is process-salted
    for i in range(count):
        rng = np.random.default_rng([seed, split_key, i])
        oh, ow = sizes[i % len(sizes)]
        img, a = _variant(image, annos, rng, (oh, ow))
        name = f"synth_{split}_{i:04d}"
        jpeg.encode(os.path.join(img_dir, name + ".jpg"), img, quality=92)
        with open(os.path.join(ann_dir, name + ".txt"), "w") as f:
            for row in a:
                f.write(",".join(str(int(round(v))) for v in row) + "\n")
        if with_roadmap:
            rm = _roadmap_from_annos(a, (oh, ow))
            jpeg.encode(os.path.join(rm_dir, name + ".jpg"), rm, quality=95)


def make_synth_dataset(out_dir: str, demo_dir: Optional[str] = None,
                       n_train: int = 32, n_val: int = 8,
                       seed: int = 219,
                       sizes: Tuple[Tuple[int, int], ...] = ((540, 960),
                                                             (512, 896)),
                       ) -> str:
    """Generate the dataset under `out_dir` (idempotent: wiped and
    rewritten). Returns out_dir (usable as cfg.data_root)."""
    if demo_dir is None:
        demo_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "data", "demo")
    ds = VisDroneDataset(demo_dir, split="")
    image = ds.load_image(ds.names[0])
    annos = parse_annotation_file(
        os.path.join(demo_dir, "annotations", ds.names[0] + ".txt"))

    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    _write_split(out_dir, "train", n_train, image, annos, sizes, seed,
                 with_roadmap=True)
    _write_split(out_dir, "val", n_val, image, annos, sizes, seed + 1,
                 with_roadmap=False)
    return out_dir
