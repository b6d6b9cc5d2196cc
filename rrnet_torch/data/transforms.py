"""Host-side (numpy) training transforms (port of
`rrnet_tpu/data/transforms.py`).

Pure numpy functions over a sample dict {image (H, W, 3) float32 [0,1],
annos (N, 8) xywh float32, roadmap (H, W) float32 or None}, each taking
an explicit `np.random.Generator`, so the pipeline is seed-deterministic
and draws the JAX package's random numbers in the same order.

The JAX package resizes with `cv2.resize`; the port does not depend on
OpenCV, so `_resize_image` redoes OpenCV's results in numpy (see there).
Heatmap targets are rendered on the device inside the train step
(`ops.targets`), not here.

Pipeline order for training (configs/rrnet_config.py:40-49):
  MultiScale -> MaskIgnore -> FillDuck -> HorizontalFlip ->
  RandomCrop(512^2) -> Normalize.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _overlap_in_a(a_xywh: np.ndarray, b_xywh: np.ndarray) -> np.ndarray:
    """intersection(a, b) / area(a) for xywh boxes -> (M, N)
    (reference bbox_iou overlap mode, metrics.py:45-46)."""
    a = a_xywh.copy()
    b = b_xywh.copy()
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.minimum(ax2[:, None], bx2[None, :]) - np.maximum(a[:, None, 0], b[None, :, 0])
    ih = np.minimum(ay2[:, None], by2[None, :]) - np.maximum(a[:, None, 1], b[None, :, 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = np.clip(a[:, 2] * a[:, 3], 1e-8, None)
    return inter / area_a[:, None]


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.minimum(ax2[:, None], bx2[None, :]) - np.maximum(a[:, None, 0], b[None, :, 0])
    ih = np.minimum(ay2[:, None], by2[None, :]) - np.maximum(a[:, None, 1], b[None, :, 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-8, None)
    return inter / union


def _source_coords(src: int, dst: int, clamp: bool, in_f32: bool):
    """OpenCV's bilinear taps along one axis: the half-pixel source
    coordinate c = (d + 0.5) * src / dst - 0.5, its floor s and fraction
    f (f32). `in_f32`: c is rounded to f32 before s and f are taken (the
    fixed-point uint8 path), else they come from c in f64. `clamp`: s < 0
    and s >= src - 1 take f = 0 at the edge (the uint8 path does so only
    along x). Returns the two source indices (read clamped) and f."""
    c = (np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5
    if in_f32:
        c = c.astype(np.float32)
    s = np.floor(c)
    f = (c - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        f[(s < 0) | (s >= src - 1)] = 0.0
        s = np.clip(s, 0, src - 1)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def _lerp_f32(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """a + f * (b - a) for f32 a, b and f64 f, rounded once to f32 after
    the multiply-add (a fused multiply-add of the f32 difference: the f64
    product of two f32 values is exact)."""
    out = np.subtract(b, a).astype(np.float64)
    out *= f
    out += a
    return out.astype(np.float32)


def _resize_linear_f32(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """`cv2.resize(img, (ow, oh), INTER_LINEAR)` on float32 as the
    x86 builds of OpenCV compute it (through IPP): rows first, then
    columns, each tap pair as one fused multiply-add a + f * (b - a) with
    f from the f64 coordinate. Bit-exact except on sources one or a few
    pixels wide, which OpenCV sends down another path (within a few f32
    ulps; tests/test_torch_data.py states the gap)."""
    h, w = img.shape[:2]
    x0, x1, fx = _source_coords(w, ow, clamp=True, in_f32=False)
    y0, y1, fy = _source_coords(h, oh, clamp=True, in_f32=False)
    fx = fx.astype(np.float64).reshape((1, ow) + (1,) * (img.ndim - 2))
    fy = fy.astype(np.float64).reshape((oh,) + (1,) * (img.ndim - 1))
    rows = _lerp_f32(np.take(img, x0, 1), np.take(img, x1, 1), fx)
    return _lerp_f32(np.take(rows, y0, 0), np.take(rows, y1, 0), fy)


def _resize_linear_u8(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """`cv2.resize(img, (ow, oh), INTER_LINEAR)` on uint8, bit-exact:
    OpenCV's fixed-point path. Each weight is rounded to 11 bits on its
    own (1 - f and f, so a pair may not sum to 2048); rows are integer
    sums; columns go through OpenCV's SIMD step, which drops 4 bits of
    each row sum, keeps the high 16 bits of each product and rounds the
    sum by 2 bits. Along y the fraction is not clamped at the edges (the
    two rows read are then the same clamped row)."""
    h, w = img.shape[:2]
    x0, x1, fx = _source_coords(w, ow, clamp=True, in_f32=True)
    y0, y1, fy = _source_coords(h, oh, clamp=False, in_f32=True)

    def fixed(f):
        return (np.rint((np.float32(1) - f).astype(np.float64) * 2048)
                .astype(np.int64), np.rint(f.astype(np.float64) * 2048)
                .astype(np.int64))

    (ax, bx), (ay, by) = fixed(fx), fixed(fy)
    ex = (1, ow) + (1,) * (img.ndim - 2)
    ey = (oh,) + (1,) * (img.ndim - 1)
    src = img.astype(np.int64)
    rows = src[:, x0] * ax.reshape(ex) + src[:, x1] * bx.reshape(ex)
    out = ((((rows[y0] >> 4) * ay.reshape(ey)) >> 16)
           + (((rows[y1] >> 4) * by.reshape(ey)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _resize_nearest(img: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """`cv2.resize(img, (ow, oh), INTER_NEAREST)`, bit-exact: source
    index floor(d * (1 / (dst / src))), clamped to the last pixel."""
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))), w - 1)
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))), h - 1)
    return img[ys.astype(np.int64)][:, xs.astype(np.int64)]


def _resize_image(img: np.ndarray, out_wh: Tuple[int, int],
                  nearest: bool = False) -> np.ndarray:
    """`cv2.resize(img, out_wh, INTER_NEAREST or INTER_LINEAR)` for the
    inputs the pipeline gives it: float32 (images in [0, 1], roadmaps)
    and uint8 (the synthetic set). Raises on an empty size or another
    dtype."""
    ow, oh = int(out_wh[0]), int(out_wh[1])
    if ow <= 0 or oh <= 0 or img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError(f"cannot resize {img.shape} to {(oh, ow)}")
    if nearest:
        return _resize_nearest(img, ow, oh)
    if img.dtype == np.float32:
        return _resize_linear_f32(img, ow, oh)
    if img.dtype == np.uint8:
        return _resize_linear_u8(img, ow, oh)
    raise TypeError(f"bilinear resize of {img.dtype} is not supported")


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def multi_scale(sample: Dict, rng: np.random.Generator,
                scales: Sequence[float] = (1.0, 1.15, 1.25, 1.35, 1.5)) -> Dict:
    """Random global rescale (transforms.py:145-151 / functional resize)."""
    s = scales[int(rng.integers(0, len(scales)))]
    img = sample["image"]
    h, w = img.shape[:2]
    ow, oh = int(w * s), int(h * s)
    out = dict(sample)
    out["image"] = _resize_image(img, (ow, oh))
    annos = sample["annos"].copy()
    if len(annos):
        annos[:, :4] *= s
    out["annos"] = annos
    if sample.get("roadmap") is not None:
        out["roadmap"] = _resize_image(sample["roadmap"], (ow, oh), nearest=True)
    return out


def mask_ignore(sample: Dict, mean: Sequence[float] = IMAGENET_MEAN,
                ignore_cls: int = 0) -> Dict:
    """Paint ignore-region boxes (cls 0) with the dataset mean, zero the
    roadmap there, and drop those annotations (functional.py:290-313)."""
    img = sample["image"].copy()
    annos = sample["annos"]
    roadmap = sample.get("roadmap")
    roadmap = roadmap.copy() if roadmap is not None else None
    ign = annos[:, 5] == ignore_cls
    for x, y, w, h in annos[ign, :4]:
        x, y, w, h = int(x), int(y), int(w), int(h)
        img[max(y, 0):y + h, max(x, 0):x + w] = np.asarray(mean, np.float32)
        if roadmap is not None:
            roadmap[max(y, 0):y + h, max(x, 0):x + w] = 0.0
    out = dict(sample)
    out["image"] = img
    out["annos"] = annos[~ign]
    out["roadmap"] = roadmap
    return out


def horizontal_flip(sample: Dict, rng: np.random.Generator,
                    p: float = 0.5) -> Dict:
    """Flip image + annos with prob p (note the reference flips when
    random() <= p, transforms.py:20-24)."""
    if rng.random() > p:
        return sample
    img = sample["image"][:, ::-1].copy()
    w = img.shape[1]
    annos = sample["annos"].copy()
    if len(annos):
        annos[:, 0] = w - annos[:, 0] - annos[:, 2]
    out = dict(sample)
    out["image"] = img
    out["annos"] = annos
    if sample.get("roadmap") is not None:
        out["roadmap"] = sample["roadmap"][:, ::-1].copy()
    return out


def normalize(sample: Dict, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> Dict:
    out = dict(sample)
    out["image"] = ((sample["image"] - np.asarray(mean, np.float32))
                    / np.asarray(std, np.float32))
    return out


def denormalize(img: np.ndarray, mean: Sequence[float] = IMAGENET_MEAN,
                std: Sequence[float] = IMAGENET_STD) -> np.ndarray:
    return img * np.asarray(std, np.float32) + np.asarray(mean, np.float32)


def color_jitter(sample: Dict, rng: np.random.Generator,
                 brightness: float = 0.5, contrast: float = 0.5,
                 saturation: float = 0.5) -> Dict:
    """Brightness/contrast/saturation jitter (transforms.py:120-130,
    PIL ImageEnhance semantics reproduced in numpy)."""
    img = sample["image"]
    b = rng.uniform(max(1 - brightness, 0), 1 + brightness)
    c = rng.uniform(max(1 - contrast, 0), 1 + contrast)
    s = rng.uniform(max(1 - saturation, 0), 1 + saturation)
    img = img * b                                    # brightness
    gray = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    img = gray.mean() + (img - gray.mean()) * c      # contrast
    img = gray[..., None] + (img - gray[..., None]) * s   # saturation
    out = dict(sample)
    out["image"] = np.clip(img, 0.0, 1.0).astype(np.float32)
    return out


def random_crop(sample: Dict, rng: np.random.Generator,
                size: Tuple[int, int] = (512, 512),
                keep_iou: float = 0.5) -> Dict:
    """Random fixed-size crop with IoU-based box retention
    (transforms.py:42-117): boxes larger than the crop are dropped from
    candidates; if no candidate survives, the image is rescaled; if the
    crop catches no box, a window around a random GT is used; after 50
    failed tries a synthetic image is emitted (the reference's "Fake
    image" fallback)."""
    ch, cw = size

    for _ in range(50):
        img = sample["image"]
        annos = sample["annos"]
        h, w = img.shape[:2]
        if (cw, ch) == (w, h):
            return sample
        if cw > w and ch > h:
            img = np.pad(img, ((0, ch - h), (0, cw - w), (0, 0)))
            return dict(sample, image=img, annos=annos)
        if cw > w or ch > h:
            img = np.pad(img, ((0, max(ch - h, 0)), (0, max(cw - w, 0)), (0, 0)))
            h, w = img.shape[:2]

        rx = rng.random() * (w - cw)
        ry = rng.random() * (h - ch)
        crop = (int(rx), int(ry), int(rx) + cw, int(ry) + ch)

        if len(annos):
            small = ~((annos[:, 2] > cw) | (annos[:, 3] > ch))
            cand = annos[small]
        else:
            cand = annos

        if len(cand) == 0:
            # current scale invalid: upscale so the crop always fits a box
            sfac = cw / min(h, w)
            img = _resize_image(img, (int(w * sfac), int(h * sfac)))
            cand = annos.copy()
            if len(cand):
                cand[:, :4] *= sfac
            h, w = img.shape[:2]
            rx = rng.random() * max(w - cw, 1)
            ry = rng.random() * max(h - ch, 1)
            crop = (int(rx), int(ry), int(rx) + cw, int(ry) + ch)

        crop_box = np.asarray([[crop[0], crop[1], cw, ch]], np.float32)
        if len(cand):
            ov = _overlap_in_a(cand[:, :4], crop_box)[:, 0]
            kept = cand[ov > keep_iou]
        else:
            kept = cand

        if len(kept) == 0 and len(cand):
            # force-include a random GT box (transforms.py:95-109)
            inc = cand[int(rng.integers(0, len(cand)))]
            x1b, y1b = inc[0], inc[1]
            x2b, y2b = inc[0] + inc[2], inc[1] + inc[3]
            lo_x, hi_x = sorted([max(0, int(x2b - cw)), int(min(x1b, w - cw))])
            lo_y, hi_y = sorted([max(0, int(y2b - ch)), int(min(y1b, h - ch))])
            x1 = int(rng.integers(lo_x, hi_x)) if lo_x != hi_x else lo_x
            y1 = int(rng.integers(lo_y, hi_y)) if lo_y != hi_y else lo_y
            crop = (x1, y1, x1 + cw, y1 + ch)
            ov = _overlap_in_a(cand[:, :4],
                               np.asarray([[x1, y1, cw, ch]], np.float32))[:, 0]
            kept = cand[ov > keep_iou]

        # shift + clip boxes into the crop (functional.py:114-132)
        out_annos = kept.copy()
        if len(out_annos):
            x2 = out_annos[:, 0] + out_annos[:, 2]
            y2 = out_annos[:, 1] + out_annos[:, 3]
            x1 = np.clip(out_annos[:, 0] - crop[0], 0, None)
            y1 = np.clip(out_annos[:, 1] - crop[1], 0, None)
            x2 = np.clip(x2 - crop[0], None, cw)
            y2 = np.clip(y2 - crop[1], None, ch)
            out_annos[:, 0], out_annos[:, 1] = x1, y1
            out_annos[:, 2], out_annos[:, 3] = x2 - x1, y2 - y1

        out_img = img[crop[1]:crop[3], crop[0]:crop[2]]
        if out_img.shape[0] == ch and out_img.shape[1] == cw:
            out = dict(sample)
            out["image"] = np.ascontiguousarray(out_img)
            out["annos"] = out_annos
            if sample.get("roadmap") is not None:
                rm = sample["roadmap"]
                if rm.shape[:2] != (h, w):
                    rm = _resize_image(rm, (w, h), nearest=True)
                out["roadmap"] = np.ascontiguousarray(
                    rm[crop[1]:crop[3], crop[0]:crop[2]])
            return out

    # 50 failures: synthetic fallback (transforms.py:114-117)
    out = dict(sample)
    out["image"] = rng.standard_normal((ch, cw, 3)).astype(np.float32)
    out["annos"] = np.asarray([[0, 0, 1, 1, 1, 1, 1, 1]], np.float32)
    out["roadmap"] = (np.zeros((ch, cw), np.float32)
                      if sample.get("roadmap") is not None else None)
    return out


# ---------------------------------------------------------------------------
# FillDuck: roadmap-guided copy-paste augmentation (functional.py:356-524)
# ---------------------------------------------------------------------------

def fill_duck(sample: Dict, rng: np.random.Generator,
              cls_list: Sequence[int] = (1, 2, 3, 7, 8, 10),
              factor: float = 0.00005) -> Dict:
    """Copy-paste rare-class objects and people+vehicle relation pairs
    onto road pixels, depth-scaling pasted objects by their y-position
    using a linear size model fit from pedestrian boxes.

    Faithful numpy port of the reference's fill_duck, including its
    whole-function try/except fallback (functional.py:522-523): any
    failure returns the sample unchanged.
    """
    try:
        return _fill_duck_inner(sample, rng, cls_list, factor)
    except Exception:
        return sample


def _fill_duck_inner(sample, rng, cls_list, factor):
    img = sample["image"]
    annos = sample["annos"]
    roadmap = sample.get("roadmap")
    if roadmap is None or len(annos) == 0:
        return sample

    ys_r, xs_r = np.nonzero(roadmap)
    if len(xs_r) == 0:
        return sample
    coor = np.stack([xs_r, ys_r], axis=1)

    cls = annos[:, 5]

    # II. depth scale from pedestrian (cls 1) boxes
    ped = annos[cls == 1, :4]
    if len(ped):
        diag = np.sqrt((ped[:, 2:4] ** 2).sum(1))
        topk = min(3, len(diag))
        max_i = np.argsort(-diag)[:topk]
        min_i = np.argsort(diag)[:1]
        y_diff = ped[max_i, 1] - ped[min_i, 1]
        scale_factor = float(np.mean(
            (diag[max_i] - diag[min_i]) / (np.abs(y_diff) + 1e-5)))
    else:
        scale_factor = 1.0

    # III. relation pairs: people (cls 2) and their highest-IoU partner
    people_annos = annos[cls == 2]
    relation = np.zeros(len(annos), bool)
    people_idx = vech_idx = None
    if len(people_annos):
        iou = _iou_xywh(people_annos[:, :4], annos[:, :4])
        if iou.shape[1] > 2:
            order = np.argsort(-iou, axis=1)[:, :2]
            vals = np.take_along_axis(iou, order, axis=1)
            ok = vals[:, 1] > 0
            pairs = order[ok]
            if len(pairs):
                people_idx = pairs[:, 0]
                vech_idx = pairs[:, 1]
                relation[people_idx] = True
                relation[vech_idx] = True

    # IV. augmentation counts
    normal = np.isin(cls.astype(int), list(cls_list)) & ~relation
    total_n = max(int(factor * roadmap.sum()), 5)
    r_total = relation.sum() / 2
    n_total = normal.sum()
    if r_total + n_total == 0:
        return sample
    r_n = int(r_total / (r_total + n_total) * total_n)
    n_n = total_n - r_n

    img = img.copy()
    h_img, w_img = img.shape[:2]
    paste_coors = coor[rng.integers(0, len(coor), size=total_n)]
    new_annos = []

    def depth_factor(ct_y, paste_y, diagonal):
        diff = abs(ct_y - paste_y) * scale_factor
        if ct_y > paste_y:
            f = 1 - diff / diagonal
        else:
            f = 1 + diff / diagonal
        return float(np.clip(f, 0.5, 2.0))

    def paste_patch(patch, px, py):
        ph, pw = patch.shape[:2]
        px = float(np.clip(px - pw / 2, 1, w_img - pw - 1))
        py = float(np.clip(py - ph / 2, 1, h_img - ph - 1))
        img[int(py):int(py) + ph, int(px):int(px) + pw] = patch
        return px, py

    # V.1 normal objects
    if n_n > 0 and normal.sum() > 0:
        pool = annos[normal]
        picks = pool[rng.integers(0, len(pool), size=n_n)]
        for i, a in enumerate(picks):
            px, py = paste_coors[i].astype(np.float32)
            ct_y = a[1] + a[3] / 2
            diagonal = math.sqrt(a[2] ** 2 + a[3] ** 2)
            if diagonal <= 0:
                continue
            f = depth_factor(ct_y, py, diagonal)
            obj = img[int(a[1]):int(a[1] + a[3]), int(a[0]):int(a[0] + a[2])]
            if obj.size == 0:
                continue
            ow = max(int(obj.shape[1] * f), 1)
            oh = max(int(obj.shape[0] * f), 1)
            if ow >= w_img - 2 or oh >= h_img - 2:
                continue
            obj = _resize_image(obj, (ow, oh))
            if obj.ndim == 2:
                obj = obj[:, :, None].repeat(3, axis=2)
            qx, qy = paste_patch(obj, px, py)
            new_annos.append([int(qx), int(qy), ow, oh,
                              a[4], a[5], a[6], a[7]])

    # V.2 relation pairs
    if r_n > 0 and people_idx is not None and len(people_idx):
        sel = rng.integers(0, len(people_idx), size=r_n)
        for i, si in enumerate(sel):
            pa = annos[people_idx[si]].copy()
            va = annos[vech_idx[si]].copy()
            # to xyxy
            pa[2:4] += pa[0:2]
            va[2:4] += va[0:2]
            min_x, min_y = int(min(pa[0], va[0])), int(min(pa[1], va[1]))
            max_x, max_y = int(max(pa[2], va[2])), int(max(pa[3], va[3]))
            if max_x <= min_x or max_y <= min_y:
                continue
            px, py = paste_coors[i + n_n].astype(np.float32)
            ct_y = (min_y + max_y) / 2
            diagonal = math.sqrt((max_x - min_x) ** 2 + (max_y - min_y) ** 2)
            f = depth_factor(ct_y, py, diagonal)
            patch = img[min_y:max_y, min_x:max_x]
            pw = max(int(patch.shape[1] * f), 1)
            ph = max(int(patch.shape[0] * f), 1)
            if pw >= w_img - 2 or ph >= h_img - 2:
                continue
            patch = _resize_image(patch, (pw, ph))
            qx, qy = paste_patch(patch, px, py)
            x_bias, y_bias = min_x - qx, min_y - qy
            for b in (pa, va):
                nb = b.copy()
                nb[2:4] -= nb[0:2]
                nb[2:4] *= f
                nb[0] -= x_bias
                nb[1] -= y_bias
                new_annos.append(np.floor(nb).tolist())

    if new_annos:
        annos = np.concatenate(
            [annos, np.asarray(new_annos, np.float32)], axis=0)
    return dict(sample, image=img, annos=annos)


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------

def train_pipeline(sample: Dict, rng: np.random.Generator, cfg,
                   as_uint8: bool = True) -> Dict:
    """Full training transform chain (configs/rrnet_config.py:40-49,
    minus device-side heatmap rendering).

    With as_uint8=True (default) the image is emitted quantized to uint8
    and NOT normalized — normalization happens on device inside the
    train step, and the host->device transfer is 4x smaller. (The pixels
    came from 8-bit JPEG anyway; re-quantization after the float
    augmentations costs <1/255 amplitude.)"""
    t = cfg.train
    sample = multi_scale(sample, rng, t.multi_scales)
    sample = mask_ignore(sample, t.mean)
    if t.fill_duck and t.with_road:
        sample = fill_duck(sample, rng, t.fill_duck_classes,
                           t.fill_duck_factor)
    sample = horizontal_flip(sample, rng, t.hflip_prob)
    sample = random_crop(sample, rng, tuple(t.crop_size))
    if as_uint8:
        img = np.clip(sample["image"] * 255.0, 0, 255).astype(np.uint8)
        return dict(sample, image=img)
    return normalize(sample, t.mean, t.std)


def val_pipeline(sample: Dict, cfg) -> Dict:
    """Eval transform: normalize only (configs/rrnet_config.py:70-73)."""
    return normalize(sample, cfg.val.mean, cfg.val.std)
