"""Input pipeline: fixed-shape batches with background prefetch (port of
`rrnet_tpu/data/loader.py`).

  * static shapes: annotations are padded or truncated to a fixed
    `max_objects` per image;
  * sharding by process: a strided share of each epoch's permutation
    (`process_index`/`process_count` are arguments; one process per card
    until the port runs DDP);
  * iteration-based: `get_batch()` never runs out; it reshuffles at the
    end of each epoch with the JAX package's seeds (`SeedSequence([seed,
    epoch])` for the permutation, `[seed, 977, n]` for the n-th sample's
    transforms), so the same config draws the same batches;
  * a small pool of threads maps the transforms ahead of the train step.
    A sample whose transforms raise is printed and skipped, as in the
    reference, and counted in `TrainLoader.skips`.

`DevicePrefetcher` stages the next batch on the card while the current
step runs: a thread pins it and copies it on a side CUDA stream, and the
consumer's stream waits on an event recorded after the copy.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from rrnet_torch.config import Config
from rrnet_torch.data import transforms as T
from rrnet_torch.data.visdrone import VisDroneDataset, parse_annotation_file
from rrnet_torch.data.yuv420 import pack_yuv420
from rrnet_torch.utils.device import resolve_device


class LoaderClosed(RuntimeError):
    """Raised by `get_batch` once the loader has been closed."""


def pad_annotations(annos: np.ndarray, max_objects: int):
    """(N, 8) -> ((max_objects, 8), (max_objects,) bool). Overflow keeps
    the largest-area boxes."""
    n = len(annos)
    out = np.zeros((max_objects, 8), np.float32)
    valid = np.zeros((max_objects,), bool)
    if n == 0:
        return out, valid
    if n > max_objects:
        order = np.argsort(-(annos[:, 2] * annos[:, 3]))
        annos = annos[order[:max_objects]]
        n = max_objects
    out[:n] = annos[:n]
    valid[:n] = True
    return out, valid


def _get(q: queue.Queue, stop: threading.Event):
    """`q.get()` that gives up once `stop` is set."""
    while True:
        try:
            return q.get(timeout=0.5)
        except queue.Empty:
            if stop.is_set():
                raise LoaderClosed("the loader was closed") from None


def _put(q: queue.Queue, item, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return
        except queue.Full:
            continue


class TrainLoader:
    """Infinite iteration-based loader over the training split."""

    def __init__(self, cfg: Config, batch_size: int,
                 dataset: Optional[VisDroneDataset] = None,
                 num_threads: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 4, start_sample: int = 0):
        """start_sample: begin at this process's n-th sample (the epoch
        and the place in it follow), so a run resumed after k steps of
        batch B draws what an uninterrupted run draws from k * B on."""
        self.cfg = cfg
        self.batch_size = batch_size
        self.dataset = dataset or VisDroneDataset(
            cfg.data_root, "train", with_road_map=cfg.train.with_road)
        self.process_index = process_index
        self.process_count = process_count
        self.max_objects = cfg.train.max_objects
        self.skips = 0          # samples whose transforms raised
        n_local = len(range(process_index, len(self.dataset), process_count))
        self.epoch, self._perm_pos = divmod(start_sample, n_local)
        self._perm = self._epoch_permutation()
        self._stop = threading.Event()
        self._queue: "queue.Queue[Dict]" = queue.Queue(maxsize=prefetch)
        n_threads = num_threads if num_threads is not None else cfg.train.num_workers
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(max(n_threads, 1))
        ]
        self._lock = threading.Lock()
        self._sample_counter = start_sample
        for t in self._threads:
            t.start()

    # -- index scheduling ---------------------------------------------------
    def _epoch_permutation(self) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, self.epoch]))
        perm = rng.permutation(len(self.dataset))
        # per-process strided shard (DistributedSampler equivalent)
        return perm[self.process_index::self.process_count]

    def _next_index(self):
        with self._lock:
            if self._perm_pos >= len(self._perm):
                self.epoch += 1
                self._perm = self._epoch_permutation()
                self._perm_pos = 0
            idx = int(self._perm[self._perm_pos])
            self._perm_pos += 1
            seed = self._sample_counter
            self._sample_counter += 1
            return idx, seed

    # -- workers ------------------------------------------------------------
    def _load_one(self, idx: int, seed: int) -> Dict:
        sample = self.dataset[idx]
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, 977, seed]))
        sample = T.train_pipeline(sample, rng, self.cfg)
        annos, valid = pad_annotations(sample["annos"], self.max_objects)
        return {"image": sample["image"], "annos": annos, "valid": valid}

    def _worker(self):
        while not self._stop.is_set():
            idx, seed = self._next_index()
            try:
                item = self._load_one(idx, seed)
            except Exception as e:   # the reference skips a failed sample
                print(f"[loader] sample {idx} failed: {e!r}", flush=True)
                with self._lock:
                    self.skips += 1
                continue
            _put(self._queue, item, self._stop)

    # -- public -------------------------------------------------------------
    def get_batch(self) -> Dict[str, np.ndarray]:
        """The next batch as numpy arrays: images (B, H, W, 3) uint8 (or
        packed (B, 1.5*H*W) YUV 4:2:0 rows with train.transport
        'yuv420'), annos (B, max_objects, 8) f32, valid (B, max_objects)
        bool. Raises LoaderClosed after `close()`."""
        items = [_get(self._queue, self._stop)
                 for _ in range(self.batch_size)]
        images = np.stack([i["image"] for i in items])
        if images.dtype == np.uint8 and self.cfg.train.transport == "yuv420":
            images = pack_yuv420(images)
        return {
            "images": images,
            "annos": np.stack([i["annos"] for i in items]),
            "valid": np.stack([i["valid"] for i in items]),
        }

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=30)


class DevicePrefetcher:
    """Wraps a TrainLoader: a thread assembles each batch and stages it
    on `device`, so batch k+1's host->device copy overlaps step k.
    `get_batch()` returns a dict of tensors on the device, ready on the
    caller's current stream."""

    def __init__(self, loader: TrainLoader,
                 device: Union[str, torch.device] = "cuda", depth: int = 2):
        self.loader = loader
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _stage(self, batch: Dict[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not self._cuda:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _worker(self):
        try:
            while not self._stop.is_set():
                _put(self._queue, self._stage(self.loader.get_batch()),
                     self._stop)
        except LoaderClosed:
            pass
        except Exception as e:   # handed to the consumer, raised there
            _put(self._queue, e, self._stop)

    def get_batch(self) -> Dict[str, torch.Tensor]:
        item = _get(self._queue, self._stop)
        if isinstance(item, Exception):
            raise item
        batch, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in batch.values():
                # made on the side stream, used on this one: the caching
                # allocator must not reuse the block before this stream
                # is done with it
                t.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        self.loader.close()
        self._thread.join(timeout=30)


class ValLoader:
    """Sequential eval loader: full-size uint8 images with their names and
    annotations (normalisation happens on the device, in the Evaluator)."""

    def __init__(self, cfg: Config, dataset: Optional[VisDroneDataset] = None,
                 split: str = "val"):
        self.cfg = cfg
        self.dataset = dataset or VisDroneDataset(cfg.data_root, split,
                                                  with_road_map=False)

    def __len__(self):
        return len(self.dataset)

    def __iter__(self) -> Iterator[Dict]:
        for name in self.dataset.names:
            image = self.dataset.load_image(name)   # uint8 HWC
            annos = parse_annotation_file(os.path.join(
                self.dataset.annotations_dir, name + ".txt"))
            yield {"name": name, "image": image, "annos": annos}


def make_loaders(cfg: Config, global_batch_size: Optional[int] = None,
                 process_index: int = 0, process_count: int = 1):
    """(train, val) loader pair; the train loader yields batches of
    `global_batch_size` (default train.batch_size) samples from this
    process's share of each epoch."""
    bs = global_batch_size or cfg.train.batch_size
    train = TrainLoader(cfg, bs, process_index=process_index,
                        process_count=process_count)
    val = ValLoader(cfg)
    return train, val
