"""Offline evaluation traffic through an anchor-based detector (the port's
RetinaNet): a stream of frames through `Evaluator.evaluate_split` at the
configuration's protocol, as `drivers.eval` streams it.

Set-up builds the port's model with the cell's weights and an
`Evaluator`, makes a pool of `pool` frames of `frame_hw` from the seed,
and warms up with two batches, traced (`warm_up_check`): a port that
does not record RetinaNet's spans, which this cell's per-layer metrics
read, or that builds the bucket's anchors other than once there, stops
the run before the window. The window streams the pool, cycled, at
`batch` frames a batch until `--seconds` have passed (ending on a whole
batch); the rate is every frame finished over the time until
`evaluate_split` returned. The stage, dispatch and collect wrappers are
`drivers.eval.Recorder`'s. For one batch of the window, drawn from the
seed among the first `check_batch_max`, a forward hook keeps the model's
(loc, cls) and a wrapper of the Evaluator's `_forward` keeps each
program's input shape, valid extents and (B, K, 6) slots; the batch's
returned rows are kept too. Once the window has closed the plain
reference (`reference/retinanet.py`) judges them (`judge`). With
`--trace 1`, `trace_batches` batches of that batch's frames are traced
in between, and the record's `counters` sum the port's counters over
the traced stretch.

The weights: `rrbench.weights.make_weights` from the seed, then
`calibrate` on the configuration's calibration frames (module docstring
of `rrbench.weights`), with RetinaNet's heads in place of RRNet's: the
loc outputs onto the configuration's `weights.loc` mean and spread, the
class logits onto mean `weights.cls_prior_logit` (the focal-loss prior
-log(99), Lin et al. section 4.1) with the spread at which
`weights.valid_per_image` of each frame's top `decode.topk` anchors
score above 0.1 on average over the calibration frames, so that the
valid mask and the NMS both do real work.

The compared numbers (limits in `rrbench/checks/<workload>.json`):

  * `out_gap`: the port's loc and class logits against the reference's
    on the same frame, each as rms(difference) over the reference's
    spread, the larger, the widest over the batch: the preprocessing,
    backbone, FPN and towers;
  * `candidate_mismatch`: the share of the K slots of the batch whose
    anchor choice differs from what the reference's decode and NMS make
    of the port's own outputs: class, box (within 1e-3 px: the decode
    is expected bit-equal, and the discrete choices are what this reads)
    and score (within 1e-6) of each slot, and its keep bit;
  * `rows_gap`: the widest difference between the rows the port returned
    for a frame and the rows made from the reference's slots of the
    port's own outputs, as the Evaluator makes rows (kept slots, the
    scale undone, sorted by score): exact, so it holds the decode's
    arithmetic, the mapping back to pixels, and every answer holding its
    own frame's rows.
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from rrbench import compare, counts, trace
from rrbench.drivers.eval import Recorder
from rrbench.frames import frames
from rrbench.reference import pipeline
from rrbench.reference import retinanet as R
from rrbench.reference.layers import BatchNorm, f32_numerics
from rrbench.weights import _bn_pass, _fit, make_weights, shapes_of

NUMBERS = ("out_gap", "candidate_mismatch", "rows_gap")
SPANS = ("retinanet.backbone", "retinanet.fpn", "retinanet.heads",
         "retinanet.decode", "retinanet.nms")
BOX_TOL = 1e-3      # px: slots' boxes, see the module docstring
SCORE_TOL = 1e-6


# ------------------------------------------------------ the reference

def arch(cell) -> dict:
    m = cell.config["model"]
    return {"num_classes": cell.config["num_classes"],
            "num_anchors": len(m["anchor_ratios"]) * len(m["anchor_scales"]),
            "backbone": m["backbone"], "channels": m["fpn_channels"]}


def reference(cell, weights) -> R.RetinaNet:
    """The reference on the cell's device with `weights` (strict)."""
    with torch.device(cell.device):
        ref = R.RetinaNet(**arch(cell))
    ref.load_state_dict(weights, strict=True)
    return ref.eval()


def anchors(cell, hw) -> torch.Tensor:
    m = cell.config["model"]
    return torch.from_numpy(R.anchors(
        tuple(hw), tuple(m["anchor_levels"]), tuple(m["anchor_sizes"]),
        tuple(m["anchor_ratios"]), tuple(m["anchor_scales"]))).to(
            cell.device)


def _inputs(cell, images):
    """The frames normalised at their bucket, (B, 3, bh, bw), the bucket
    and their (B, 2) int32 extents, as the Evaluator makes them."""
    val, bm = cell.config["val"], cell.traffic["bucket_multiple"]
    xs = [pipeline.normalized(f, val["mean"], val["std"], cell.device,
                              val["transport"], bm) for f in images]
    vhw = torch.tensor([f.shape[:2] for f in images], dtype=torch.int32,
                       device=cell.device)
    return torch.cat([x for x, _ in xs]), xs[0][1], vhw


@torch.no_grad()
def calibrate(cell, model, images) -> None:
    """The weights recipe of the module docstring, in place, on the
    reference `model` and the calibration `images`."""
    w = cell.config["weights"]
    x, bucket, vhw = _inputs(cell, images)
    with f32_numerics():
        _bn_pass([m for m in model.modules() if isinstance(m, BatchNorm)],
                 lambda: model(x))
        for tower, (mean, std) in ((model.loc, w["loc"]),
                                   (model.cls, (0.0, 1.0))):
            outs = []
            hook = tower.out.register_forward_hook(
                lambda mod, a, out: outs.append(out.flatten(2)))
            try:
                model(x)
            finally:
                hook.remove()
            _fit(tower.out.weight, tower.out.bias, torch.cat(outs, 2),
                 mean, std, (0, 2))
        # the top k anchors of each frame by their best standardised
        # logit z: a threshold t on z leaves the prefix z > t valid
        _, cls = model(x)
        a = anchors(cell, bucket)
        k = cell.config["decode"]["topk"]
        cx, cy = (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2
        inside = (cx[None] < vhw[:, 1:2]) & (cy[None] < vhw[:, 0:1])
        z = torch.where(inside, cls.max(-1).values, -torch.inf).sort(
            dim=-1, descending=True, stable=True).values[:, :k]

        def mean_valid(t):
            return float((z > t).sum(1).float().mean())

        target = w["valid_per_image"]
        if mean_valid(0.0) <= target:
            raise ValueError(f"{k} candidates hold fewer than {target} "
                             f"above the mean")
        lo, hi = 0.0, float(z[:, 0].max())
        for _ in range(60):
            t = (lo + hi) / 2
            lo, hi = (t, hi) if mean_valid(t) > target else (lo, t)
        p = R.SCORE_THRESHOLD
        spread = (math.log(p / (1 - p)) - w["cls_prior_logit"]) / hi
        out = model.cls.out
        out.weight.mul_(spread)
        out.bias.mul_(spread).add_(w["cls_prior_logit"])


def weights_for(cell, module) -> Dict[str, torch.Tensor]:
    """The cell's seeded, calibrated weights for `module`'s state dict,
    on the host, after checking its parameter count against the
    configuration file."""
    n = sum(p.numel() for p in module.parameters())
    if cell.check_params and n != cell.config["param_count"]:
        raise ValueError(f"the port's {cell.config['name']} has {n} "
                         f"parameters, the configuration file "
                         f"{cell.config['param_count']}")
    w = cell.config["weights"]
    ref = reference(cell, make_weights(shapes_of(module), cell.seed,
                                       cell.device,
                                       tuple(w["branch_end_scale"])))
    calibrate(cell, ref, frames(cell.seed, w["calibration_frames"],
                                tuple(w["calibration_hw"])))
    out = {k: v.detach().to("cpu", copy=True)
           for k, v in ref.state_dict().items()}
    del ref
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def flops_per_image(cell, hw) -> float:
    """FLOPs of the reference's forward of one image at input `hw`,
    counted on meta tensors (the decode and NMS do no matrix work)."""
    with torch.device("meta"):
        model = R.RetinaNet(**arch(cell))
        x = torch.empty((1, 3, *hw))
    with FlopCounterMode(display=False) as fc:
        model(x)
    return float(fc.get_total_flops())


# ----------------------------------------------------------- the check

class Capture:
    """While `armed`: the model's (loc, cls) of each forward (a forward
    hook) and each program's (input hw, valid extents, slots) (a wrapper
    of the Evaluator's `_forward`, on the instance)."""

    def __init__(self, ev):
        self.armed = False
        self.outputs: List = []
        self.programs: List = []
        self.handle = ev.model.register_forward_hook(self._hook)
        inner = ev._forward

        def forward(x, vhw):
            out = inner(x, vhw)
            if self.armed:
                self.programs.append((tuple(x.shape[-2:]), vhw, out))
            return out

        ev._forward = forward

    def _hook(self, module, args, out):
        if self.armed:
            self.outputs.append(out)

    def close(self):
        self.handle.remove()


def _slot_mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of (K, 6) slots whose class, box, keep bit or kept
    score differ."""
    if got.shape != want.shape:
        return 1.0
    got, want = got.float(), want.float()
    kept = want[:, 4] >= 0.0
    same = (((got[:, 4] >= 0.0) == kept)
            & (got[:, 5] == want[:, 5])
            & ((got[:, :4] - want[:, :4]).abs() <= BOX_TOL).all(-1)
            & (~kept | ((got[:, 4] - want[:, 4]).abs() <= SCORE_TOL)))
    return float(1.0 - same.float().mean())


@torch.no_grad()
def judge(ref, cell, images, outputs, program, returned):
    """The compared numbers of one checked batch: `images` the frame of
    each slot, `outputs` the side's (loc, cls) of the batch, `program`
    its (input hw, valid extents, (B, K, 6) slots), `returned[j]` the
    rows it gave for frame j (None where the answer never came). Also
    the reference's candidates of the side's outputs, and what lies
    beside the check (`look`)."""
    loc, cls = outputs
    hw, vhw, slots = program
    x, bucket, _ = _inputs(cell, images)
    with f32_numerics():
        c, keep = R.decode(loc, cls, anchors(cell, hw), vhw.to(x.device),
                           slots.shape[1])
        want = R.packed(c, keep)
        gaps, mismatch, rows = [], [], []
        for j in range(len(images)):
            rl, rc = ref(x[j:j + 1])
            gaps.append(max(pipeline.gap(loc[j], rl[0]),
                            pipeline.gap(cls[j], rc[0])))
            mismatch.append(_slot_mismatch(slots[j], want[j]))
            rebuilt = R.rows(want[j], (hw[0] / bucket[0],
                                       hw[1] / bucket[1]))
            rows.append(compare.rows_gap(returned[j], rebuilt))
    numbers = {"out_gap": max(gaps), "candidate_mismatch": max(mismatch),
               "rows_gap": max(rows)}
    look = {"valid_per_image": c.valid.sum(1).tolist(),
            "kept_per_image": keep.sum(1).tolist()}
    return numbers, c, look


def missing() -> Dict[str, float]:
    return {k: compare.MISSING for k in NUMBERS}


def controls(cell, frames_checked: int = 4) -> dict:
    """The float8 reference (`reference.layers.set_fp8`) in the port's
    place on `frames_checked` frames of the pool, one a batch, judged as
    a run judges the port; its slots and rows are the reference decode's
    of its own outputs."""
    from rrbench.reference.layers import set_fp8
    tr = cell.traffic
    with torch.device("meta"):
        shapes = R.RetinaNet(**arch(cell))
    weights = weights_for(cell, shapes)
    ref, low = reference(cell, weights), set_fp8(reference(cell, weights))
    k = cell.config["decode"]["topk"]
    numbers = []
    for f in frames(cell.seed, tr["pool"], tuple(tr["frame_hw"]))[
            :frames_checked]:
        x, bucket, vhw = _inputs(cell, [f])
        with torch.no_grad(), f32_numerics():
            out = low(x)
            c, keep = R.decode(*out, anchors(cell, bucket), vhw, k)
        slots = R.packed(c, keep)
        got, _, _ = judge(ref, cell, [f], out, (bucket, vhw, slots),
                          [R.rows(slots[0])])
        numbers.append(got)
    return {"fp8": {k: max(n[k] for n in numbers) for k in NUMBERS}}


# ------------------------------------------------------------- the run

def warm_up_check(records) -> None:
    """Raise unless the traced warm-up's `records` hold each of `SPANS`
    and one `retinanet.anchor_builds`: the spans are what the cell's
    `retina_*` readers read, and the one build is the bucket's anchors
    made in set-up, so that the window makes none."""
    names = {r["name"] for r in records}
    lacking = [s for s in SPANS if s not in names]
    builds = sum(r["counts"].get("retinanet.anchor_builds", 0)
                 for r in records)
    if lacking or builds != 1:
        raise RuntimeError(
            f"the port cannot run this cell: its warm-up recorded no "
            f"{lacking} spans and {builds} anchor builds (want none "
            f"lacking and 1)")


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell, setup_done=lambda: None) -> dict:
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_model
    from rrnet_torch.utils import tracing

    tr = cell.traffic
    dev = cell.device
    cfg = cell.port_config()
    model = build_model(cfg, device=dev)
    weights = weights_for(cell, model)
    model.load_state_dict(weights, strict=True)
    ev = Evaluator(cfg, model, device=dev,
                   bucket_multiple=tr["bucket_multiple"])
    checked = int(np.random.default_rng([cell.seed, 3]).integers(
        0, tr["check_batch_max"]))
    rec = Recorder(ev, checked)
    rec.capture.close()             # RRNet's capture, replaced by this one
    rec.capture = Capture(ev)
    pool = frames(cell.seed, tr["pool"], tuple(tr["frame_hw"]))
    batch = tr["batch"]
    out_dir = tempfile.mkdtemp(prefix="rrbench-anchor-eval-")

    def stream(limit_s=None, images=None):
        if images is not None:
            for i, im in enumerate(images):
                yield {"name": f"t{i:06d}", "image": im}
            return
        end, i = time.perf_counter() + limit_s, 0
        while time.perf_counter() < end or i % batch:
            yield {"name": f"f{i:06d}", "image": pool[i % len(pool)]}
            i += 1

    try:
        tracing.clear()
        tracing.enable()
        try:
            ev.evaluate_split(stream(images=pool[:2 * batch]), out_dir,
                              batch_size=batch, verbose=False)
            _sync(dev)
        finally:
            tracing.disable()
        warm_up_check(tracing.records())
        tracing.clear()
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
        tr_rec, since = None, len(tracing.records())
        if cell.trace:
            tr_rec = trace.traced(lambda: ev.evaluate_split(
                stream(images=slots * tr["trace_batches"]), out_dir,
                batch_size=batch, verbose=False))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        rec.capture.close()
    cap, rows = rec.capture, rec.rows
    attempted = rec.dispatched * batch
    del ev, model
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()

    cands, flops, hard_nms, look = None, None, None, {}
    if rows is None or len(cap.outputs) != 1 or len(cap.programs) != 1:
        numbers = missing()
    else:
        ref = reference(cell, weights)
        numbers, cands, look = judge(ref, cell, slots, cap.outputs[0],
                                     cap.programs[0], rows)
        del ref
    counters: Dict[str, int] = {}
    for r in tracing.records()[since:] if cell.trace else ():
        for name, n in r["counts"].items():
            counters[name] = counters.get(name, 0) + n
    if counters:
        look["counters"] = counters
    if cell.trace and cap.programs:
        flops = flops_per_image(cell, cap.programs[0][0])
        if cands is not None:
            b, v = cands.boxes, cands.valid
            hard_nms = {"bound_ms": counts.batch_bound_ms([
                            counts.hard_nms_work(
                                b[j:j + 1], R.NMS_IOU, valid=v[j:j + 1],
                                plus_one=True)
                            for j in range(b.shape[0])]),
                        "device_s": trace.kernel_calls(tr_rec, "hard_nms")}
    return {"attempted": attempted, "failed": attempted - rec.done,
            "e2e": {"eval_images_per_s": rec.done / window},
            "window_s": window, "memory_peak_bytes": peak,
            "spans": {"stage": rec.stage, "issue": rec.issue},
            "counters": counters,
            "work": {"images": rec.done, "flops_per_image": flops},
            "hard_nms": hard_nms, "trace": tr_rec, "numbers": numbers,
            "look": look}
