"""Latency-oriented serving (port of `rrnet_tpu/serving.py`).

`Predictor` serves a model at deployment settings (one scale, no flip)
through `evallib.infer.Evaluator`, so serving and offline eval share one
path. `warmup()` runs dummy requests at the request shapes, so the first
real request pays for no lazy set-up (kernel build, cuDNN plans, the
sticky wire shape, the staging scratch). `quantize="int8"` serves the
int8 body convolutions after `calibrate(images)`.

`MicroBatcher` is a dynamic batcher in front of a `Predictor`: a worker
thread groups requests that arrive within `max_delay_ms` of each other
by shape bucket into batches of up to `max_batch`, and keeps up to
`pipeline_depth` batches in flight (batch k+1 is uploaded and queued
while batch k computes). Each `submit()` returns a
`concurrent.futures.Future` of the (N, 6) detections `predict` gives.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rrnet_torch.config import Config
from rrnet_torch.evallib.infer import Evaluator, _round_up

__all__ = ["Predictor", "MicroBatcher"]


class Predictor:
    """Single-request detector at deployment settings.

    cfg, model, device, bucket_multiple, quantize: as for `Evaluator`.
    deployment: when True the val protocol is forced to one scale and no
        flip, whatever the preset says.
    image_shapes: (H, W) shapes `warmup()` prepares by default."""

    def __init__(self, cfg: Config, model: torch.nn.Module, *,
                 device: Union[str, torch.device] = "cuda",
                 deployment: bool = True,
                 image_shapes: Sequence[Tuple[int, int]] = ((765, 1360),),
                 bucket_multiple: int = 128, latency_window: int = 256,
                 quantize: Optional[str] = None):
        if deployment:
            cfg = cfg.replace(val=dataclasses.replace(
                cfg.val, scales=(1.0,), flip_tta=False))
        self.cfg = cfg
        self.image_shapes = [tuple(s) for s in image_shapes]
        self._ev = Evaluator(cfg, model, device=device,
                             bucket_multiple=bucket_multiple,
                             quantize=quantize)
        self._latencies = deque(maxlen=latency_window)
        self._lock = threading.Lock()
        self.warmed_up = False

    def warmup(self, image_shapes: Optional[Iterable[Tuple[int, int]]] = None,
               batch_sizes: Sequence[int] = (1,)) -> int:
        """Run one zero image batch per (request shape, batch size) —
        request shapes, not bucket shapes, since the wire shape follows
        the request. Returns the number of batches run. An int8 predictor
        must be calibrated first: its lazy calibration would otherwise
        take the zero dummies' ranges."""
        if self._ev.quantize is not None and self._ev._quant_scales is None:
            raise RuntimeError(
                "Predictor(quantize='int8') must be calibrated on "
                "representative images before warmup(): call "
                "calibrate(images) first")
        shapes = [tuple(s) for s in (image_shapes or self.image_shapes)]
        runs = 0
        for (h, w) in shapes:
            dummy = np.zeros((h, w, 3), np.uint8)
            for b in batch_sizes:
                self._ev.predict_batch([dummy] * b)
                runs += 1
        self.warmed_up = True
        return runs

    def update_variables(self, state) -> None:
        """Load a new state dict (a new checkpoint); the int8 calibration
        and packed weights are dropped. Call `warmup()` again before
        latency-sensitive traffic."""
        self._ev.update_variables(state)
        self.warmed_up = False

    def calibrate(self, images) -> Dict[str, float]:
        """For quantize='int8': record the convs' input ranges on
        representative images before `warmup()`."""
        return self._ev.calibrate(images)

    def bucket_of(self, image: np.ndarray) -> Tuple[int, int]:
        return (_round_up(image.shape[0], self._ev.bucket_multiple),
                _round_up(image.shape[1], self._ev.bucket_multiple))

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
    # queues device work (the result copies included), collect waits for
    # that batch's own work and none queued after it.
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


class _Request:
    __slots__ = ("image", "future")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.future: Future = Future()


_STOP = object()


class MicroBatcher:
    """Dynamic micro-batching in front of a `Predictor` (module
    docstring). After the first request of a batch arrives the worker
    waits at most `max_delay_ms` for more, up to `max_batch`; under load
    batches fill at once, at low traffic a request pays at most the delay.
    A closed-loop client never has two batches in flight, so its latency
    is that of single requests plus the delay. `batch_sizes` records each
    group's size."""

    def __init__(self, predictor: Predictor, max_batch: int = 8,
                 max_delay_ms: float = 4.0, pipeline_depth: int = 2):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.pipeline_depth = int(pipeline_depth)
        self.max_delay = float(max_delay_ms) / 1e3
        self.batch_sizes: List[int] = []
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one image; the Future resolves to (N, 6) detections."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        req = _Request(image)
        self._q.put(req)
        return req.future

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests; serve what is queued, then stop the
        worker."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        if wait:
            self._worker.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker ----------------------------------------------------------
    def _collect_batch(self, block: bool = True
                       ) -> Tuple[List[_Request], bool]:
        """The next requests: wait for the first (or, with block=False,
        return at once when none is waiting), then gather more until
        max_batch or the delay's deadline. Returns (requests, stop seen)."""
        try:
            first = self._q.get(block=block)
        except queue.Empty:
            return [], False
        if first is _STOP:
            return [], True
        batch = [first]
        deadline = time.monotonic() + self.max_delay
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is _STOP:
                return batch, True
            batch.append(nxt)
        return batch, False

    @staticmethod
    def _resolve(fut: Future, result) -> None:
        # False iff the caller cancelled the future; once True it cannot
        # be cancelled, so set_result cannot raise
        if fut.set_running_or_notify_cancel():
            fut.set_result(result)

    @staticmethod
    def _reject(fut: Future, exc: BaseException) -> None:
        if fut.set_running_or_notify_cancel():
            fut.set_exception(exc)

    def _resolve_group(self, handle, group: List[_Request]) -> None:
        """Collect one batch in flight and resolve its futures."""
        try:
            preds = self.predictor.collect(handle)
        except Exception as e:
            for r in group:
                self._reject(r.future, e)
        else:
            for r, p in zip(group, preds):
                self._resolve(r.future, p)

    def _loop(self) -> None:
        in_flight: deque = deque()   # (handle, group), oldest first
        while True:
            # with batches in flight take only what has arrived (its
            # upload overlaps their compute), else resolve the oldest
            batch, stop = self._collect_batch(block=not in_flight)
            if batch:
                groups: Dict[Tuple[int, int], List[_Request]] = {}
                for req in batch:
                    # a malformed request fails its own future only
                    try:
                        bucket = self.predictor.bucket_of(req.image)
                    except Exception as e:
                        self._reject(req.future, e)
                        continue
                    groups.setdefault(bucket, []).append(req)
                for group in groups.values():
                    self.batch_sizes.append(len(group))
                    try:
                        staged = self.predictor.stage(
                            [r.image for r in group])
                        handle = self.predictor.dispatch(staged)
                    except Exception as e:
                        for r in group:
                            self._reject(r.future, e)
                        continue
                    in_flight.append((handle, group))
                    while len(in_flight) >= self.pipeline_depth:
                        self._resolve_group(*in_flight.popleft())
            elif in_flight and not stop:
                self._resolve_group(*in_flight.popleft())
            if stop:
                while in_flight:
                    self._resolve_group(*in_flight.popleft())
                # serve what was queued before close() won the race
                while True:
                    try:
                        req = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if req is _STOP:
                        continue
                    try:
                        pred = self.predictor.predict(req.image)
                    except Exception as e:
                        self._reject(req.future, e)
                    else:
                        self._resolve(req.future, pred)
