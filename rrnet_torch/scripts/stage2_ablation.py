"""Coarse-ROI stage-2 ablation (port of `scripts/stage2_ablation.py`):

    python -m rrnet_torch.scripts.stage2_ablation [--steps 800]
        [--batch 8] [--dir DIR] [--out STAGE2_ABLATION_torch.json]
        [--device cuda] [key=value ...]

Does the trained stage-2 head refine boxes in the regime it exists for,
stage-1 ROIs that err by several feature pixels? Trains the full-width
`rrnet` preset for `--steps` at `--batch` with stage 2 gated off for the
first steps // 4 on the synthetic set (`data.synth`, 32 + 8 images, seed
219), then runs the 8 val images, each resized into the train crop and
padded (one batch), with gaussian `roi_jitter` of 0, 0.5, 1 and 2
feature px (numpy seed 7) on the selected ROIs. The metric is the mean
best IoU against the ground truth of the kept boxes (stage-1 score >
0.2), for the full stage-2 decode and for the same decode with all-zero
deltas on the same jittered ROIs: their difference is what the head
adds.

Writes the record to `--out` (never the JAX package's
`STAGE2_ABLATION.json`) and prints the JAX package's TPU rows beside its
own where that file is in the checkout.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import DevicePrefetcher, TrainLoader
from rrnet_torch.data.synth import make_synth_dataset
from rrnet_torch.data.transforms import _resize_image
from rrnet_torch.data.visdrone import VisDroneDataset, parse_annotation_file
from rrnet_torch.ops import box as boxops
from rrnet_torch.train import Trainer
from rrnet_torch.utils.device import device_record

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JITTERS = (0.0, 0.5, 1.0, 2.0)
JITTER_SEED = 7
SCORE_MIN = 0.2


def val_batch(cfg):
    """The val split resized into the train crop (top-left, aspect kept)
    and normalised: x (B, 3, ch, cw) f32, the boxes scaled alike as
    (B, N, 4) xyxy and their (B, N) validity, as numpy."""
    ds = VisDroneDataset(cfg.data_root, split="val")
    ch, cw = cfg.train.crop_size
    mean = np.asarray(cfg.train.mean, np.float32)
    std = np.asarray(cfg.train.std, np.float32)
    raw = [(ds.load_image(n), parse_annotation_file(
        os.path.join(ds.annotations_dir, n + ".txt"))) for n in ds.names]
    max_n = max(1, max(len(a) for _, a in raw))
    imgs, annos, valids = [], [], []
    for img, ann in raw:
        h, w = img.shape[:2]
        s = min(ch / h, cw / w)
        nh, nw = int(round(h * s)), int(round(w * s))
        canvas = np.zeros((ch, cw, 3), img.dtype)
        canvas[:nh, :nw] = _resize_image(img, (nw, nh))
        a = np.zeros((max_n, 4), np.float32)
        a[:len(ann)] = ann[:, :4].astype(np.float32) * s
        v = np.zeros((max_n,), bool)
        v[:len(ann)] = True
        imgs.append((canvas.astype(np.float32) / 255.0 - mean) / std)
        annos.append(a)
        valids.append(v)
    xywh = np.stack(annos)
    xyxy = np.concatenate([xywh[..., :2], xywh[..., :2] + xywh[..., 2:]], -1)
    return (np.stack(imgs).transpose(0, 3, 1, 2).copy(), xyxy,
            np.stack(valids))


def mean_best_iou(rois, stage2_reg, roi_valid, roi_scores, gt_xyxy, valid,
                  scale_factor: float):
    """(full, zero): the mean over kept ROIs (valid, score > 0.2) of each
    decoded box's best IoU with a valid ground-truth box, decoding the
    stage-2 deltas and all-zero deltas on the same ROIs (feature coords,
    scaled by `scale_factor` to pixels first)."""
    r = rois.float() * scale_factor
    rois_xywh = torch.cat([r[..., :2], r[..., 2:4] - r[..., :2]], -1)
    w = (roi_valid & (roi_scores > SCORE_MIN)).float()

    def miou(deltas):
        xywh = boxops.decode_boxes(rois_xywh, deltas)
        xyxy = torch.cat([xywh[..., :2], xywh[..., :2] + xywh[..., 2:4]], -1)
        iou = torch.where(valid[:, None, :],
                          boxops.pairwise_iou(xyxy, gt_xyxy), 0.0)
        best = iou.max(-1).values
        return (best * w).sum() / w.sum().clamp_min(1.0)

    reg = stage2_reg.float()
    return miou(reg), miou(torch.zeros_like(reg))


def ablation_rows(model, x, gt_xyxy, valid, scale_factor: float,
                  jitters=JITTERS, seed: int = JITTER_SEED):
    """One row a jitter: the two mean IoUs and their difference. The
    jitter of every row is drawn in turn from one numpy RandomState."""
    rng = np.random.RandomState(seed)
    b, r = x.shape[0], model.stage2_rois
    rows = []
    for fpx in jitters:
        jit = torch.from_numpy((rng.randn(b, r, 4) * fpx).astype(np.float32))
        with torch.no_grad():
            outs = model(x, roi_jitter=jit.to(x.device))
            full, zero = mean_best_iou(outs.rois, outs.stage2_reg,
                                       outs.roi_valid, outs.roi_scores,
                                       gt_xyxy, valid, scale_factor)
        f, z = float(full), float(zero)
        rows.append({"jitter_feature_px": fpx, "stage2_mean_iou": f,
                     "zero_delta_mean_iou": z, "stage2_gain": f - z})
    return rows


def train(cfg, steps: int, batch: int, device):
    """Train `cfg` for `steps` at `batch` through the loader; returns (the
    model in eval mode with the trained weights, the last total loss,
    seconds). A non-finite last loss raises."""
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    loader = DevicePrefetcher(TrainLoader(cfg, batch), device=trainer.device)
    t0 = time.perf_counter()
    try:
        for step in range(steps):
            state, metrics = trainer.train_step(state, loader.get_batch())
            if step % 200 == 199:
                print(f"# step {step + 1}: {float(metrics['total']):.4f}",
                      file=sys.stderr)
        final = float(metrics["total"])
    finally:
        loader.close()
    if not math.isfinite(final):
        raise RuntimeError(f"non-finite final loss {final}")
    secs = time.perf_counter() - t0
    model = trainer.model
    model.load_state_dict(state.state_dict())
    return model.eval(), final, secs


def tpu_rows(path: str):
    """The JAX package's rows from its record, where the file exists."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("rows")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.stage2_ablation",
        description="Train RRNet on the synthetic set and measure what "
                    "stage 2 adds on jittered ROIs.")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dir", default=os.path.join(REPO, "build",
                                                  "rrnet_synth"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "STAGE2_ABLATION_torch.json"))
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    make_synth_dataset(args.dir, n_train=32, n_val=8, seed=219)
    warmup = args.steps // 4
    cfg = cfglib.apply_overrides(cfglib.rrnet_config(), [
        f"data_root={args.dir}", f"train.batch_size={args.batch}",
        f"train.iter_num={args.steps}",
        f"train.stage2_warmup_steps={warmup}", *args.overrides])
    model, final_loss, train_s = train(cfg, args.steps, args.batch,
                                       args.device)
    print(f"# trained {args.steps} steps in {train_s:.1f} s", file=sys.stderr)
    dev = next(model.parameters()).device
    x, gt, valid = val_batch(cfg)
    rows = ablation_rows(model, torch.from_numpy(x).to(dev),
                         torch.from_numpy(gt).to(dev),
                         torch.from_numpy(valid).to(dev),
                         float(cfg.train.scale_factor))
    tpu = tpu_rows(os.path.join(REPO, "STAGE2_ABLATION.json"))
    for i, row in enumerate(rows):
        line = (f"# jitter {row['jitter_feature_px']}: full "
                f"{row['stage2_mean_iou']:.4f} zero "
                f"{row['zero_delta_mean_iou']:.4f} gain "
                f"{row['stage2_gain']:+.4f}")
        if tpu and i < len(tpu):
            line += (f"   (TPU, JAX package: full {tpu[i]['stage2_mean_iou']}"
                     f" zero {tpu[i]['zero_delta_mean_iou']} gain "
                     f"{tpu[i]['stage2_gain']:+})")
        print(line, file=sys.stderr)
    result = {
        "ablation": "coarse-ROI stage-2 refinement (roi_jitter)",
        "protocol": f"rrnet preset (full width, {cfg.model.dtype}) trained "
                    f"{args.steps} steps at batch {args.batch} (stage-2 "
                    f"warmup {warmup}) on the synthetic set (32+8 images, "
                    "seed 219); the 8 val images resized into the crop; "
                    f"gaussian roi_jitter {list(JITTERS)} feature px (numpy "
                    f"seed {JITTER_SEED}) on the selected ROIs; metric = "
                    "mean best IoU of kept boxes (score > 0.2) vs GT, full "
                    "stage-2 decode vs zero-delta decode on the same ROIs",
        "device": device_record(dev),
        "train": {"steps": args.steps, "batch": args.batch,
                  "stage2_warmup_steps": warmup, "wall_s": train_s,
                  "final_loss": final_loss},
        "rows": rows,
        "jax_record": "STAGE2_ABLATION.json (TPU v5e)",
    }
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
