"""Offline evaluation traffic: a stream of frames through the port's
`Evaluator.evaluate_split` at the configuration's protocol.

Set-up builds the model with the cell's weights and an `Evaluator`,
makes a pool of `pool` frames of `frame_hw` from the seed, and warms up
with two batches. The window streams the pool, cycled, into
`evaluate_split` at `batch` frames a batch until `--seconds` have passed
(ending on a whole batch); the rate is every frame finished over the
time until `evaluate_split` returned. The benchmark wraps the
Evaluator's `stage`, `dispatch_batch` and `collect` on the object it
built (host time a call; the rows returned) and hooks the model's
forward for one batch of the window, drawn from the seed among the first
`check_batch_max`: its forwards and rows are what the reference judges
(`drivers.detect`) once the window has closed. With `--trace 1`,
`trace_batches` batches of that batch's frames are traced in between.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from rrbench import counts, trace
from rrbench.drivers import detect
from rrbench.frames import frames
from rrbench.reference.model import build_rrnet


class Recorder:
    """Host times of the wrapped calls, the rows of the checked batch,
    and the forwards captured for it."""

    def __init__(self, ev, checked: int):
        self.on = False
        self.checked = checked
        self.stage, self.issue, self.rows = [], [], None
        self.dispatched = self.collected = self.done = 0
        self.capture = detect.Capture(ev.model)
        stage, dispatch, collect = ev.stage, ev.dispatch_batch, ev.collect

        def timed_stage(images):
            t = time.perf_counter()
            out = stage(images)
            if self.on:
                self.stage.append((time.perf_counter() - t, len(images)))
            return out

        def timed_dispatch(batch):
            self.capture.armed = self.on and self.dispatched == self.checked
            t = time.perf_counter()
            out = dispatch(batch)
            if self.on:
                self.issue.append(time.perf_counter() - t)
                self.dispatched += 1
            self.capture.armed = False
            return out

        def kept_collect(handle):
            out = collect(handle)
            if self.on:
                if self.collected == self.checked:
                    self.rows = out
                self.collected += 1
                self.done += len(out)
            return out

        ev.stage, ev.dispatch_batch, ev.collect = (timed_stage,
                                                   timed_dispatch,
                                                   kept_collect)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell, setup_done=lambda: None) -> dict:
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_model

    tr = cell.traffic
    dev = cell.device
    cfg = cell.port_config()
    model = build_model(cfg, device=dev)
    weights = cell.weights_for(model)
    model.load_state_dict(weights, strict=True)
    ev = Evaluator(cfg, model, device=dev,
                   bucket_multiple=tr["bucket_multiple"])
    checked = int(np.random.default_rng([cell.seed, 3]).integers(
        0, tr["check_batch_max"]))
    rec = Recorder(ev, checked)
    pool = frames(cell.seed, tr["pool"], tuple(tr["frame_hw"]))
    batch = tr["batch"]
    out_dir = tempfile.mkdtemp(prefix="rrbench-eval-")

    def stream(limit_s=None, images=None):
        """Items for evaluate_split: `images` as given, or the pool
        cycled until limit_s has passed, on a whole batch."""
        if images is not None:
            for i, im in enumerate(images):
                yield {"name": f"t{i:06d}", "image": im}
            return
        end, i = time.perf_counter() + limit_s, 0
        while time.perf_counter() < end or i % batch:
            yield {"name": f"f{i:06d}", "image": pool[i % len(pool)]}
            i += 1

    try:
        ev.evaluate_split(stream(images=pool[:2 * batch]), out_dir,
                          batch_size=batch, verbose=False)
        _sync(dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        rec.on = True
        setup_done()
        t0 = time.perf_counter()
        ev.evaluate_split(stream(limit_s=cell.seconds), out_dir,
                          batch_size=batch, verbose=False)
        window = time.perf_counter() - t0
        rec.on = False
        peak = (torch.cuda.max_memory_allocated(dev)
                if torch.device(dev).type == "cuda" else 0)
        slots = [pool[(checked * batch + j) % len(pool)]
                 for j in range(batch)]
        tr_rec = None
        if cell.trace:
            tr_rec = trace.traced(lambda: ev.evaluate_split(
                stream(images=slots * tr["trace_batches"]), out_dir,
                batch_size=batch, verbose=False))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        rec.capture.close()
    forwards, rows = rec.capture.forwards, rec.rows
    attempted = rec.dispatched * batch
    del ev, model
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    cands, flops, hard_nms = None, None, None
    if rows is None or not forwards:
        numbers = detect.missing()
    else:
        ref = cell.reference(weights)
        numbers, cands = detect.judge(ref, cfg, slots, forwards, rows,
                                      tr["bucket_multiple"])
        del ref
    if cell.trace:
        meta = counts.meta_model(lambda: build_rrnet(cell.arch()))
        flops = sum(counts.forward_flops(meta, (1, 3, *f.hw))
                    for f in forwards)
        if cands is not None:
            hard_nms = {"bound_ms": detect.hard_nms_bound_ms(
                            cands, cfg.model.stage1_nms_iou),
                        "device_s": trace.kernel_calls(tr_rec, "hard_nms")}
    return {"attempted": attempted, "failed": attempted - rec.done,
            "e2e": {"eval_images_per_s": rec.done / window},
            "window_s": window, "memory_peak_bytes": peak,
            "spans": {"stage": rec.stage, "issue": rec.issue},
            "work": {"images": rec.done, "flops_per_image": flops},
            "hard_nms": hard_nms, "trace": tr_rec, "numbers": numbers}
