"""Latency-oriented serving (port of `rrnet_tpu/serving.py:46-176`).

`Predictor` serves a model at deployment settings (one scale, no flip)
through `evallib.infer.Evaluator`, so serving and offline eval share one
path. `warmup()` runs dummy requests at the request shapes, so the first
real request pays for no lazy set-up (kernel build, cuDNN plans, the
sticky wire shape, the staging scratch). The dynamic `MicroBatcher` of
the JAX package is not ported yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rrnet_torch.config import Config
from rrnet_torch.evallib.infer import Evaluator

__all__ = ["Predictor"]


class Predictor:
    """Single-request detector at deployment settings.

    cfg, model, device, bucket_multiple: as for `Evaluator`.
    deployment: when True the val protocol is forced to one scale and no
        flip, whatever the preset says.
    image_shapes: (H, W) shapes `warmup()` prepares by default."""

    def __init__(self, cfg: Config, model: torch.nn.Module, *,
                 device: Union[str, torch.device] = "cuda",
                 deployment: bool = True,
                 image_shapes: Sequence[Tuple[int, int]] = ((765, 1360),),
                 bucket_multiple: int = 128, latency_window: int = 256):
        if deployment:
            cfg = cfg.replace(val=dataclasses.replace(
                cfg.val, scales=(1.0,), flip_tta=False))
        self.cfg = cfg
        self.image_shapes = [tuple(s) for s in image_shapes]
        self._ev = Evaluator(cfg, model, device=device,
                             bucket_multiple=bucket_multiple)
        self._latencies = deque(maxlen=latency_window)
        self._lock = threading.Lock()
        self.warmed_up = False

    def warmup(self, image_shapes: Optional[Iterable[Tuple[int, int]]] = None,
               batch_sizes: Sequence[int] = (1,)) -> int:
        """Run one zero image batch per (request shape, batch size) —
        request shapes, not bucket shapes, since the wire shape follows
        the request. Returns the number of batches run."""
        shapes = [tuple(s) for s in (image_shapes or self.image_shapes)]
        runs = 0
        for (h, w) in shapes:
            dummy = np.zeros((h, w, 3), np.uint8)
            for b in batch_sizes:
                self._ev.predict_batch([dummy] * b)
                runs += 1
        self.warmed_up = True
        return runs

    def predict(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB -> (N, 6) [x, y, w, h, score, cls]
        detections in original pixels, sorted by score."""
        t0 = time.perf_counter()
        out = self._ev.predict(image)
        self._record(time.perf_counter() - t0)
        return out

    def predict_batch(self, images: List[np.ndarray]) -> List[np.ndarray]:
        """Batched variant; the images may differ in size within one
        shape bucket."""
        t0 = time.perf_counter()
        outs = self._ev.predict_batch(images)
        self._record(time.perf_counter() - t0)
        return outs

    # Splitting predict_batch into stage / dispatch / collect lets a
    # caller upload batch k+1 while batch k computes: dispatch only
    # queues device work, collect waits for it.
    def stage(self, images: List[np.ndarray]):
        """Upload a same-bucket image list; returns a staged batch."""
        return self._ev._upload(images)

    def dispatch(self, staged):
        """Queue a staged batch; returns a handle for collect."""
        return self._ev.dispatch_batch(staged)

    def collect(self, handle) -> List[np.ndarray]:
        """Wait for a dispatched handle and post-process it on the host."""
        return self._ev.collect(handle)

    def _record(self, dt: float) -> None:
        with self._lock:
            self._latencies.append(dt)

    def latency_stats(self) -> Dict[str, float]:
        """p50/p90/p99/mean over the trailing request window, seconds."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
        if lat.size == 0:
            return {"count": 0}
        return {"count": int(lat.size),
                "mean_s": float(lat.mean()),
                "p50_s": float(np.percentile(lat, 50)),
                "p90_s": float(np.percentile(lat, 90)),
                "p99_s": float(np.percentile(lat, 99))}
