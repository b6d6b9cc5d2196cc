"""Multi-scale, flip-TTA inference over full images with shape
bucketing, RRNet, CenterNet and RetinaNet branches (port of
`rrnet_tpu/evallib/infer.py:79-678`).

One host->device transfer per batch, as uint8: images are padded on the
host to a 16-rounded wire shape (sticky per bucket, so same-bucket
requests reuse one shape), packed (planar I420 or raw RGB) and copied
once from pinned memory. On the device, once a batch: unpack,
edge-replicate pad to the bucket, normalize. Then per protocol scale
(`val.scales`) and flip: bilinear resize to the scaled bucket
(`bucket * scale` rounded up to `bucket_multiple`), horizontal flip
within each image's valid width, forward, decode, and one packed
(B, K, 6) [x, y, w, h, score, cls] result, so `collect` makes one
device->host copy per program. Flip TTA runs the flipped and unflipped
halves as one 2B forward (`fuse_flip=True`, the default) or as two.

`collect` undoes the flip and the scale, concatenates each image's rows
over the programs and, for `val.auto_test=False`, merges them on the
host: score filter, then per-class gaussian soft-NMS (`host_nms`).
RetinaNet's rows are score-filtered and hard-NMS'd on the device, and
the reference applies no host NMS after them
(retinanet_operator.py:250-258), so they are never merged.
`evaluate_split` runs a whole split through a three-stage pipeline
(upload on a thread, compute, collect) and writes VisDrone result txts.

`quantize="int8"` runs the eligible body convolutions as int8
(`models.layers.quant_context`, `ops.int8_conv`) after `calibrate` has
recorded each one's input absmax; a dispatch calibrates on its own batch
when `calibrate` was never called. The mode is entered inside
`dispatch_batch`, around the forwards, so that it holds in whatever
thread dispatches (a context variable set by another thread is not
seen there).

`devices=[...]` evaluates data-parallel within one process (the JAX
package's `Evaluator(mesh=)`, which shards each batch over a mesh's data
axis): one model replica per device, each batch split into contiguous
slices, one a device, staged and dispatched replica by replica (their
device work overlaps), and the rows gathered back in order. int8
calibration runs on every slice and keeps each conv's largest absmax,
which is the whole batch's.
"""

from __future__ import annotations

import contextlib
import copy
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F

from rrnet_torch.config import Config
from rrnet_torch.data.yuv420 import pack_yuv420, unpack_yuv420_device
from rrnet_torch.evallib import host_nms
from rrnet_torch.evallib.writer import save_result
from rrnet_torch.models import retinanet
from rrnet_torch.models.anchors import model_anchors
from rrnet_torch.models.layers import (drop_int8_weights, name_quant_convs,
                                       quant_context,
                                       quant_scales_from_stats)
from rrnet_torch.models.modules import resize_bilinear
from rrnet_torch.models.rrnet import mask_heatmap_extent
from rrnet_torch.ops.box import decode_boxes
from rrnet_torch.ops.heatmap import topk_decode
from rrnet_torch.utils import tracing
from rrnet_torch.utils.device import resolve_device


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class StagedBatch(NamedTuple):
    """A host batch already on the device (from `Evaluator._upload`)."""
    payload: torch.Tensor   # (B, wire bytes) uint8 on the device
    bucket: Tuple[int, int]
    hws: List[Tuple[int, int]]
    tight: Tuple[int, int]  # wire shape (padding to bucket added on device)
    valid_hw: torch.Tensor  # (B, 2) int32 [h, w] of each image, on the device


class ShardedBatch(NamedTuple):
    """A batch split over a data-parallel Evaluator's replicas: (replica,
    its slice's StagedBatch or dispatch handle), in batch order."""
    parts: List[Tuple["Evaluator", object]]


def _flip_valid_width(img: torch.Tensor, w_valid: torch.Tensor
                      ) -> torch.Tensor:
    """Flip only the first w_valid[b] columns of each (B, C, H, W) image
    horizontally, so the content stays left-aligned and the extent mask
    still applies."""
    w = img.shape[-1]
    xs = torch.arange(w, device=img.device)[None, :]
    wv = w_valid.to(img.device, torch.int64)[:, None]
    src = torch.where(xs < wv, wv - 1 - xs, xs)
    return torch.gather(img, 3, src[:, None, None, :].expand(img.shape))


def scaled_valid_hw(valid_hw: torch.Tensor, bucket: Tuple[int, int],
                    scaled: Tuple[int, int]) -> torch.Tensor:
    """Each image's valid [h, w] in the scaled bucket, (B, 2) int32:
    ceil(valid * scaled / bucket), the product an f32 multiply by the
    ratio rounded to f32, as the JAX package computes it (an f64 ceil
    moves the extent by a pixel at some widths, and the flip's mirror
    with it). A tensor times a Python float multiplies in f32."""
    vhw = valid_hw.float()
    return torch.stack([torch.ceil(vhw[:, 0] * (scaled[0] / bucket[0])),
                        torch.ceil(vhw[:, 1] * (scaled[1] / bucket[1]))],
                       dim=1).to(torch.int32)


class Evaluator:
    """Runs a trained RRNet, CenterNet or RetinaNet over full images and
    produces (N, 6) [x, y, w, h, score, cls(1-based)] detections in
    original pixels, with the preset's eval protocol (`cfg.val`: scales,
    flip TTA, auto_test)."""

    def __init__(self, cfg: Config, model: torch.nn.Module, *,
                 device: Union[str, torch.device] = "cuda",
                 bucket_multiple: int = 128, decode_topk: int = 250,
                 fuse_flip: bool = True, stage2_decode: str = "full",
                 quantize: Optional[str] = None,
                 devices: Optional[Sequence[Union[str, torch.device]]] = None):
        """model: the port's RRNet, CenterNet or RetinaNet (moved to
        `device`, set to eval). decode_topk: CenterNet's top-k per image;
        RetinaNet takes 4 * decode_topk anchors (at most all of them) into
        its NMS; RRNet takes `model.topk`. fuse_flip: flip TTA as one
        forward of 2B images (True) or two of B. stage2_decode (RRNet):
        "full" applies the stage-2 deltas, "stage1" reports the stage-1
        ROIs, "zero" decodes with all-zero deltas. quantize: None or
        "int8" (module docstring). devices: evaluate data-parallel over
        these devices (`device` is then the first), one replica of
        `model` each (module docstring)."""
        if cfg.model.name not in ("rrnet", "centernet", "retinanet"):
            raise NotImplementedError(f"Evaluator for {cfg.model.name!r} "
                                      "is not ported yet")
        if stage2_decode not in ("full", "stage1", "zero"):
            raise ValueError(f"stage2_decode must be full/stage1/zero, "
                             f"got {stage2_decode!r}")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got "
                             f"{quantize!r}")
        self.cfg = cfg
        if devices:
            device = devices[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.quantize = quantize
        self._quant_scales: Optional[Dict[str, float]] = None
        if quantize is not None:
            name_quant_convs(self.model)
        self.stage2_decode = stage2_decode
        self.bucket_multiple = bucket_multiple
        self.decode_topk = decode_topk
        self.fuse_flip = fuse_flip
        self.transport = cfg.val.transport
        self.mean = torch.tensor(cfg.val.mean, dtype=torch.float32,
                                 device=self.device)[:, None, None]
        self.std = torch.tensor(cfg.val.std, dtype=torch.float32,
                                device=self.device)[:, None, None]
        self._tight_cache: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._anchors: Dict[Tuple[int, int], torch.Tensor] = {}
        self._pad_scratch: Dict[Tuple, np.ndarray] = {}
        self._shapes_run: set = set()   # input shapes dispatched so far
        self._batch_seq = 0             # the next batch id of evaluate_split
        self._replicas = [self] + [
            Evaluator(cfg, copy.deepcopy(self.model), device=d,
                      bucket_multiple=bucket_multiple,
                      decode_topk=decode_topk, fuse_flip=fuse_flip,
                      stage2_decode=stage2_decode, quantize=quantize)
            for d in (devices or ())[1:]]

    # ------------------------------------------------------------------
    def _normalize(self, staged: StagedBatch) -> torch.Tensor:
        """Wire payload -> normalized (B, 3, bh, bw) f32 at the bucket."""
        (bh, bw), (th, tw) = staged.bucket, staged.tight
        flat = staged.payload
        n = flat.shape[0]
        if self.transport == "yuv420":
            x = unpack_yuv420_device(flat, th, tw) / 255.0
        else:
            x = flat.reshape(n, th, tw, 3).float() / 255.0
        x = x.permute(0, 3, 1, 2)
        if (th, tw) != (bh, bw):
            # edge-replicate, as the host pad: at scales > 1 the bilinear
            # resize samples ~1 px past the valid extent, and a zero band
            # would bleed -mean/std into the valid border
            x = F.pad(x, (0, bw - tw, 0, bh - th), mode="replicate")
        return (x - self.mean) / self.std

    def _preprocess(self, staged: StagedBatch, scaled: Tuple[int, int],
                    flip, base: Optional[torch.Tensor] = None):
        """The input of one program: the normalized bucket (`base`, or
        made from `staged`) resized to `scaled` and flipped (False, True,
        or "both": unflipped then flipped, 2B images). Returns (x, the
        scaled valid [h, w] per image as a (B or 2B, 2) int32 tensor)."""
        x = self._normalize(staged) if base is None else base
        bucket = staged.bucket
        if tuple(scaled) != tuple(bucket):
            x = resize_bilinear(x, scaled)
            vhw = scaled_valid_hw(staged.valid_hw, bucket, scaled)
        else:
            vhw = staged.valid_hw       # ceil(v * 1.0) == v: nothing to do
        if flip == "both":
            x = torch.cat([x, _flip_valid_width(x, vhw[:, 1])], dim=0)
            vhw = torch.cat([vhw, vhw], dim=0)
        elif flip:
            x = _flip_valid_width(x, vhw[:, 1])
        return x, vhw

    def _model(self, x: torch.Tensor, vhw: torch.Tensor):
        if self.cfg.model.name == "rrnet":
            return self.model(x, valid_hw=vhw)
        return self.model(x)

    def calibrate(self, images) -> Dict[str, float]:
        """Record every eligible conv's input absmax on one representative
        batch (a list of images, or what `stage` made of one): one forward
        per distinct scale of `val.scales` (a mirrored image has the same
        values, so no flip), the elementwise max kept. Stores and returns
        the scales {conv name: absmax}; raises if no conv was eligible."""
        if len(self._replicas) == 1:
            return self._calibrate(images)
        parts = images if isinstance(images, ShardedBatch) else \
            self.stage(list(images))
        found = [r._calibrate(st) for r, st in parts.parts]
        scales = {k: max(f[k] for f in found) for k in found[0]}
        for r in self._replicas:
            r._quant_scales = scales
        return scales

    def _calibrate(self, images) -> Dict[str, float]:
        staged = images if isinstance(images, StagedBatch) else \
            self._upload(list(images))
        stats = []
        with torch.inference_mode():
            base = self._normalize(staged)
            for scale in dict.fromkeys(self.cfg.val.scales):
                scaled = self._scaled_shape(staged.bucket, scale)
                x, vhw = self._preprocess(staged, scaled, False, base)
                with quant_context("calibrate") as ctx:
                    self._model(x, vhw)
                stats.append(ctx.stats)
        scales = quant_scales_from_stats(stats)
        if not scales:
            raise RuntimeError("calibration recorded no conv ranges: the "
                               "model has no quantization-eligible "
                               "convolutions")
        self._quant_scales = scales
        return scales

    def update_variables(self, state: Mapping[str, torch.Tensor]) -> None:
        """Load a new state dict into the model; the calibration scales
        and the packed int8 weights are dropped (the next int8 dispatch
        calibrates again)."""
        for r in self._replicas:
            r.model.load_state_dict(state)
            r._quant_scales = None
            drop_int8_weights(r.model)

    def _quant(self):
        """The int8 mode with this Evaluator's scales, or nothing."""
        if self.quantize is None:
            return contextlib.nullcontext()
        return quant_context("int8", dict(self._quant_scales))

    def _forward(self, x: torch.Tensor, vhw: torch.Tensor) -> torch.Tensor:
        """Forward + decode -> (B, K, 6) packed rows [x, y, w, h, score,
        cls + 1]; invalid rows get score -1."""
        s = self.cfg.train.scale_factor
        if self.cfg.model.name == "retinanet":
            loc, cls = self._model(x, vhw)
            anchors = self.anchors_for(tuple(x.shape[-2:]))
            return retinanet.decode(loc, cls, anchors, vhw,
                                    min(4 * self.decode_topk,
                                        anchors.shape[0]))
        if self.cfg.model.name == "centernet":
            # the last stack only, decoded to the top decode_topk with no
            # peak NMS (the reference operator's transform_bbox)
            hms, whs, regs = self._model(x, vhw)
            hm = mask_heatmap_extent(hms[-1].float(), vhw, s)
            dets = topk_decode(hm, whs[-1].float(), regs[-1].float(),
                               k=self.decode_topk, scale_factor=float(s))
            boxes = dets.boxes
            xywh = torch.cat([boxes[..., :2], boxes[..., 2:4] - boxes[..., :2]],
                             -1)
            score = torch.where(dets.scores > 0, dets.scores, -1.0)
            cls = dets.classes.float() + 1.0
            return torch.cat([xywh, score[..., None], cls[..., None]], dim=-1)
        outs = self._model(x, vhw)
        rois_xyxy = outs.rois * s
        rois_xywh = torch.cat([rois_xyxy[..., :2],
                               rois_xyxy[..., 2:4] - rois_xyxy[..., :2]], -1)
        deltas = outs.stage2_reg.float()
        if self.stage2_decode == "full":
            xywh = decode_boxes(rois_xywh, deltas)
        elif self.stage2_decode == "zero":
            xywh = decode_boxes(rois_xywh, torch.zeros_like(deltas))
        else:
            xywh = rois_xywh
        score = torch.where(outs.roi_valid, outs.roi_scores, -1.0)
        cls = outs.roi_classes.float() + 1.0
        return torch.cat([xywh, score[..., None], cls[..., None]], dim=-1)

    def anchors_for(self, shape: Tuple[int, int]) -> torch.Tensor:
        """RetinaNet's anchors of an input shape, on the device, made once
        a shape (the copy is the only host step; a later forward of the
        shape makes none)."""
        if shape not in self._anchors:
            self._anchors[shape] = torch.tensor(
                model_anchors(self.cfg.model, shape), device=self.device)
        return self._anchors[shape]

    # ------------------------------------------------------------------
    def _upload(self, images) -> StagedBatch:
        """Pad a list of same-bucket images on the host and ship them as
        ONE uint8 batch (raw RGB, or planar I420 at half the bytes)."""
        hs = [im.shape[0] for im in images]
        ws = [im.shape[1] for im in images]
        bh = _round_up(max(hs), self.bucket_multiple)
        bw = _round_up(max(ws), self.bucket_multiple)
        # wire shape: the 16-rounded batch max, grow-only per bucket; the
        # rest of the bucket is padded on the device
        th = min(_round_up(max(hs), 16), bh)
        tw = min(_round_up(max(ws), 16), bw)
        sth, stw = self._tight_cache.get((bh, bw), (0, 0))
        th, tw = max(th, sth), max(tw, stw)
        self._tight_cache[(bh, bw)] = (th, tw)
        key = (threading.get_ident(), th, tw)
        scr = self._pad_scratch.get(key)
        if scr is None or scr.shape[0] < len(images):
            scr = np.zeros((len(images), th, tw, 3), np.uint8)
            self._pad_scratch[key] = scr
        padded = scr[:len(images)]
        with tracing.span("eval.stage.pad"):
            for i, im in enumerate(images):
                if im.dtype != np.uint8:
                    im = np.clip(im * 255.0, 0, 255).astype(np.uint8)
                padded[i, :im.shape[0], :im.shape[1]] = im
                if im.shape[0] < th:
                    padded[i, im.shape[0]:] = padded[i, im.shape[0] - 1]
                if im.shape[1] < tw:
                    padded[i, :, im.shape[1]:] = \
                        padded[i, :, im.shape[1] - 1][:, None]
        with tracing.span("eval.stage.pack"):
            if self.transport == "yuv420":
                flat = pack_yuv420(padded)
            else:
                flat = padded.reshape(len(images), -1)
        hws = list(zip(hs, ws))
        # one host buffer and one copy: the wire rows, then each image's
        # valid [h, w] as int32 (a row's bytes are a multiple of 4, since
        # th and tw are multiples of 16). On the card the buffer is
        # pinned; the caching host allocator keeps the block until the
        # copy has finished, so the next batch cannot overwrite it
        n, row = flat.shape
        with tracing.span("eval.stage.copy"):
            buf = torch.empty(n * (row + 8), dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            host = buf.numpy()
            host[:n * row] = flat.reshape(-1)
            host[n * row:].view(np.int32)[:] = \
                np.asarray(hws, np.int32).ravel()
            wire = buf.to(self.device, non_blocking=True)
        payload = wire[:n * row].view(n, row)
        valid_hw = wire[n * row:].view(torch.int32).view(n, 2)
        return StagedBatch(payload, (bh, bw), hws, (th, tw), valid_hw)

    def stage(self, images):
        """Ship a same-bucket list of images to the device(s): a
        StagedBatch, or with several replicas a ShardedBatch of contiguous
        slices (sizes differing by at most one, empty ones left out)."""
        with tracing.span("eval.stage"):
            if len(self._replicas) == 1:
                return self._upload(images)
            cuts = np.cumsum([0] + [len(a) for a in np.array_split(
                np.arange(len(images)), len(self._replicas))])
            return ShardedBatch([(r, r._upload(images[a:b])) for r, a, b in
                                 zip(self._replicas, cuts[:-1], cuts[1:])
                                 if b > a])

    def _scaled_shape(self, bucket: Tuple[int, int], scale: float
                      ) -> Tuple[int, int]:
        return (_round_up(int(bucket[0] * scale), self.bucket_multiple),
                _round_up(int(bucket[1] * scale), self.bucket_multiple))

    # ------------------------------------------------------------------
    def dispatch_batch(self, images):
        """Queue the device work of every (scale, flip) program for a
        same-bucket batch (a list of HWC uint8 images, or what `stage`
        made of one); returns a handle for `collect`."""
        with tracing.span("eval.dispatch"):
            if len(self._replicas) > 1:
                parts = images if isinstance(images, ShardedBatch) else \
                    self.stage(images)
                if self.quantize is not None and self._quant_scales is None:
                    self.calibrate(parts)   # lazily, on the first batch
                return ShardedBatch([(r, r._dispatch(st))
                                     for r, st in parts.parts])
            return self._dispatch(images)

    def _dispatch(self, images):
        cfg = self.cfg
        staged = images if isinstance(images, StagedBatch) else \
            self._upload(images)
        if self.quantize is not None and self._quant_scales is None:
            self.calibrate(staged)      # lazily, on the first batch
        if cfg.val.flip_tta:
            flips = ("both",) if self.fuse_flip else (True, False)
        else:
            flips = (False,)
        pending = []
        with torch.inference_mode(), self._quant():
            base = self._normalize(staged)
            for scale in cfg.val.scales:
                scaled = self._scaled_shape(staged.bucket, scale)
                ry = scaled[0] / staged.bucket[0]
                rx = scaled[1] / staged.bucket[1]
                for flip in flips:
                    with tracing.span("eval.program", scale=scale):
                        x, vhw = self._preprocess(staged, scaled, flip, base)
                        pending.append((self._forward(x, vhw), flip, ry, rx))
                    if x.shape not in self._shapes_run:
                        # a shape cuDNN has not planned for in this process
                        self._shapes_run.add(x.shape)
                        tracing.count("eval.new_shapes")
        return pending, staged.hws

    def collect(self, handle) -> List[np.ndarray]:
        """Copy a dispatched batch to the host -> per-image (N, 6) rows in
        original pixels, sorted by score (stable); with
        `val.auto_test=False`, merged on the host first (`merge`), except
        for RetinaNet, whose rows the device already NMS'd."""
        with tracing.span("eval.collect"):
            rows = self.gather(handle)
            if self.cfg.val.auto_test or self.cfg.model.name == "retinanet":
                return rows
            with tracing.span("eval.merge"):
                return [self.merge(pred) for pred in rows]

    def gather(self, handle) -> List[np.ndarray]:
        """Per image, the rows of every program of a dispatched batch in
        original pixels (flip and scale undone), concatenated and sorted
        by score (stable)."""
        if isinstance(handle, ShardedBatch):
            return [rows for r, h in handle.parts for rows in r.gather(h)]
        pending, hws = handle
        n = len(hws)
        host = []
        for packed, _, _, _ in pending:
            # a blocking copy: it waits for all the work queued before it
            with tracing.span("eval.copy"):
                tracing.count("eval.d2h_syncs")
                host.append(packed.cpu().numpy())
        with tracing.span("eval.rows"):
            per_img: List[List[np.ndarray]] = [[] for _ in range(n)]
            for packed, (_, flip, ry, rx) in zip(host, pending):
                packed = packed.astype(np.float64)
                # a fused flip program returns 2n images: [0, n)
                # unflipped, [n, 2n) flipped
                for idx in range(packed.shape[0]):
                    b = idx % n
                    flipped = bool(flip) if flip != "both" else idx >= n
                    rows = packed[idx][packed[idx, :, 4] >= 0.0]
                    if flipped:
                        # the scaled valid width, as preprocess rounds it
                        w_s = float(np.ceil(np.float32(hws[b][1]) *
                                            np.float32(rx)))
                        rows[:, 0] = w_s - rows[:, 0] - rows[:, 2]
                    rows[:, [0, 2]] /= rx
                    rows[:, [1, 3]] /= ry
                    per_img[b].append(rows)
            outs = []
            for parts in per_img:
                pred = np.concatenate(parts, axis=0)
                outs.append(pred[np.argsort(-pred[:, 4], kind="stable")])
        return outs

    def merge(self, pred: np.ndarray) -> np.ndarray:
        """The host merge of one image's gathered rows (`val.auto_test=
        False`): rows scoring above `val.score_threshold`, per-class
        gaussian soft-NMS (`model.soft_nms`: Nt, score threshold), sorted
        by score (stable)."""
        cfg = self.cfg
        pred = pred[pred[:, 4] > cfg.val.score_threshold]
        pred = host_nms.per_class_soft_nms_xywh(
            pred, Nt=cfg.model.soft_nms.iou_threshold,
            threshold=cfg.model.soft_nms.score_threshold)
        return pred[np.argsort(-pred[:, 4], kind="stable")]

    def predict_batch(self, images) -> List[np.ndarray]:
        return self.collect(self.dispatch_batch(images))

    def predict(self, image: np.ndarray) -> np.ndarray:
        return self.predict_batch([image])[0]

    # ------------------------------------------------------------------
    def evaluate_split(self, loader, result_dir: Optional[str] = None,
                       max_images: Optional[int] = None,
                       batch_size: int = 4, verbose: bool = True) -> str:
        """Run a split (an iterable of {"name", "image"} items, e.g.
        `data.loader.ValLoader`), writing one VisDrone txt per image
        (the reference's evaluation_process). Images are grouped by
        bucket into batches; a leftover batch is padded to `batch_size`
        with copies of its last image, whose outputs are dropped. Batch
        k+1 is uploaded on a thread while batch k computes, and batch k
        is collected and written after batch k+1 is dispatched. Each
        batch gets the next id of this Evaluator's sequence, which the
        spans of its read, upload, dispatch, collect and write carry
        (`utils.tracing`). Returns the result dir."""
        result_dir = result_dir or self.cfg.val.result_dir
        os.makedirs(result_dir, exist_ok=True)
        style = ("centernet" if self.cfg.model.name == "centernet"
                 else "rrnet")

        def bucket_of(img):
            return (_round_up(img.shape[0], self.bucket_multiple),
                    _round_up(img.shape[1], self.bucket_multiple))

        uploader = ThreadPoolExecutor(max_workers=1)
        queues: Dict[Tuple[int, int], List] = {}
        staged = []      # (upload future, names, batch id): in transfer
        in_flight = []   # (handle, names, batch id): compute in progress
        done = 0

        def stage(batch_id, imgs):
            with tracing.batch(batch_id):
                return self.stage(imgs)

        def dispatch(entry):
            fut, names, batch_id = entry
            with tracing.batch(batch_id):
                with tracing.span("eval.wait_upload"):
                    upload = fut.result()
                in_flight.append((self.dispatch_batch(upload), names,
                                  batch_id))

        def drain(entry):
            nonlocal done
            handle, names, batch_id = entry
            with tracing.batch(batch_id):
                preds = self.collect(handle)
                with tracing.span("eval.write"):
                    for name, pred in zip(names, preds):
                        save_result(os.path.join(result_dir, name + ".txt"),
                                    pred, style=style)
            done += len(names)
            if verbose:
                print(f"\r[{done}]", end="", flush=True)

        def pump():
            """Advance the pipeline: upload -> compute -> collect."""
            while len(staged) > 1 or (staged and not in_flight):
                dispatch(staged.pop(0))
                if len(in_flight) > 1:
                    drain(in_flight.pop(0))

        def flush(q, pad_to: Optional[int] = None):
            names = [it["name"] for it in q]
            imgs = [it["image"] for it in q]
            if pad_to and len(imgs) < pad_to:
                imgs = imgs + [imgs[-1]] * (pad_to - len(imgs))
            batch_id, self._batch_seq = self._batch_seq, self._batch_seq + 1
            staged.append((uploader.submit(stage, batch_id, imgs), names,
                           batch_id))
            pump()

        try:
            items = iter(loader)
            count = 0
            while max_images is None or count < max_images:
                # the read is counted in the batch that flushes next
                with tracing.batch(self._batch_seq), \
                        tracing.span("eval.read"):
                    item = next(items, None)
                if item is None:
                    break
                count += 1
                b = bucket_of(item["image"])
                queues.setdefault(b, []).append(item)
                if len(queues[b]) >= batch_size:
                    flush(queues.pop(b))
            for q in list(queues.values()):
                flush(q, pad_to=batch_size)
            while staged:
                dispatch(staged.pop(0))
            while in_flight:
                drain(in_flight.pop(0))
        finally:
            uploader.shutdown()
        if verbose:
            print("\n=> Evaluation Done!")
        return result_dir
