"""Bucketed inference over full images, rrnet branch (port of
`rrnet_tpu/evallib/infer.py:79-600`).

One host->device transfer per batch, as uint8: images are padded on the
host to a 16-rounded wire shape (sticky per bucket, so same-bucket
requests reuse one shape), packed (planar I420 or raw RGB) and copied
once from pinned memory. On the device: unpack, edge-replicate pad to
the bucket, normalize, forward, stage-2 decode, and one packed
(B, R, 6) [x, y, w, h, score, cls] result per batch, so `collect` makes
one device->host copy.

Ported so far: scale 1.0 without flip (the deployment setting), and the
preset's `val.auto_test=True` path, which runs no host soft-NMS. Other
scales, flip TTA and the host-NMS merge come with the eval slice and
raise NotImplementedError until then.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from rrnet_torch.config import Config
from rrnet_torch.data.yuv420 import pack_yuv420, unpack_yuv420_device
from rrnet_torch.ops.box import decode_boxes
from rrnet_torch.utils.device import resolve_device


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


class StagedBatch(NamedTuple):
    """A host batch already on the device (from `Evaluator._upload`)."""
    payload: torch.Tensor   # (B, wire bytes) uint8 on the device
    bucket: Tuple[int, int]
    hws: List[Tuple[int, int]]
    tight: Tuple[int, int]  # wire shape (padding to bucket added on device)


class Evaluator:
    """Runs an RRNet over full images and produces (N, 6)
    [x, y, w, h, score, cls(1-based)] detections in original pixels."""

    def __init__(self, cfg: Config, model: torch.nn.Module, *,
                 device: Union[str, torch.device] = "cuda",
                 bucket_multiple: int = 128, stage2_decode: str = "full"):
        """model: the port's RRNet (moved to `device`, set to eval).
        stage2_decode: "full" applies the stage-2 deltas, "stage1" reports
        the stage-1 ROIs, "zero" decodes with all-zero deltas."""
        if cfg.model.name != "rrnet":
            raise NotImplementedError(f"Evaluator for {cfg.model.name!r} "
                                      "is not ported yet")
        if stage2_decode not in ("full", "stage1", "zero"):
            raise ValueError(f"stage2_decode must be full/stage1/zero, "
                             f"got {stage2_decode!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.stage2_decode = stage2_decode
        self.bucket_multiple = bucket_multiple
        self.transport = cfg.val.transport
        self.mean = torch.tensor(cfg.val.mean, dtype=torch.float32,
                                 device=self.device)[:, None, None]
        self.std = torch.tensor(cfg.val.std, dtype=torch.float32,
                                device=self.device)[:, None, None]
        self._tight_cache: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._pad_scratch: Dict[Tuple, np.ndarray] = {}

    # ------------------------------------------------------------------
    def _preprocess(self, staged: StagedBatch) -> torch.Tensor:
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
            # edge-replicate, as the host pad: a zero band would bleed
            # -mean/std into the valid border through a resize
            x = F.pad(x, (0, bw - tw, 0, bh - th), mode="replicate")
        return (x - self.mean) / self.std

    def _forward(self, staged: StagedBatch) -> torch.Tensor:
        """Forward + stage-2 decode -> (B, R, 6) packed rows; invalid rows
        get score -1."""
        x = self._preprocess(staged)
        vhw = torch.tensor(staged.hws, dtype=torch.int32, device=self.device)
        outs = self.model(x, valid_hw=vhw)
        s = self.cfg.train.scale_factor
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
        for i, im in enumerate(images):
            if im.dtype != np.uint8:
                im = np.clip(im * 255.0, 0, 255).astype(np.uint8)
            padded[i, :im.shape[0], :im.shape[1]] = im
            if im.shape[0] < th:
                padded[i, im.shape[0]:] = padded[i, im.shape[0] - 1]
            if im.shape[1] < tw:
                padded[i, :, im.shape[1]:] = \
                    padded[i, :, im.shape[1] - 1][:, None]
        if self.transport == "yuv420":
            flat = pack_yuv420(padded)
        else:
            flat = padded.reshape(len(images), -1).copy()
        host = torch.from_numpy(flat)
        if self.device.type == "cuda":
            # the caching host allocator keeps the block until the copy
            # has finished, so the next batch cannot overwrite it
            host = host.pin_memory()
        payload = host.to(self.device, non_blocking=True)
        return StagedBatch(payload, (bh, bw), list(zip(hs, ws)), (th, tw))

    # ------------------------------------------------------------------
    def dispatch_batch(self, images):
        """Queue the device work for a same-bucket batch (a list of HWC
        uint8 images, or a StagedBatch); returns a handle for `collect`."""
        cfg = self.cfg
        if cfg.val.flip_tta:
            raise NotImplementedError("flip TTA is not ported yet")
        if tuple(cfg.val.scales) != (1.0,):
            raise NotImplementedError(
                f"eval scales {cfg.val.scales} are not ported yet; the "
                "deployment setting is (1.0,)")
        staged = images if isinstance(images, StagedBatch) else \
            self._upload(images)
        with torch.inference_mode():
            out = self._forward(staged)
        return out, len(staged.hws)

    def collect(self, handle) -> List[np.ndarray]:
        """Copy a dispatched batch to the host -> per-image (N, 6) rows
        sorted by score."""
        packed, n = handle
        if not self.cfg.val.auto_test:
            raise NotImplementedError("the host soft-NMS merge "
                                      "(val.auto_test=False) is not ported "
                                      "yet")
        packed = packed.cpu().numpy().astype(np.float64)
        outs = []
        for i in range(n):
            rows = packed[i][packed[i, :, 4] >= 0.0]
            outs.append(rows[np.argsort(-rows[:, 4], kind="stable")])
        return outs

    def predict_batch(self, images) -> List[np.ndarray]:
        return self.collect(self.dispatch_batch(images))

    def predict(self, image: np.ndarray) -> np.ndarray:
        return self.predict_batch([image])[0]
