"""Synthetic train -> eval -> AP gate for the rrnet, centernet,
retinanet and rrnet_hrnetv2_attention families (port of
`scripts/synth_gate.py`'s rows; the JAX gate has no row for the fourth):

    python -m rrnet_torch.scripts.synth_gate
        [--family rrnet|centernet|retinanet|rrnet_hrnetv2_attention]
        [--steps N] [--batch 8] [--dir DIR] [--out SYNTH_AP_torch.json]
        [--int8-delta] [--device cuda] [key=value ...]

Makes the deterministic 32+8-image VisDrone-format set from the demo
fixture (`data.synth`, seed 219), trains the family's preset on it
through the whole input pipeline (`TrainLoader` -> `DevicePrefetcher` ->
`Trainer.train_step`), then runs `Evaluator.evaluate_split` over the 8
val images (scale 1, no flip, batch 4) and `evaluate_results`. The JAX
gate's schedules: rrnet 1600 steps with stage 2 gated off for the first
steps // 4, scored for three decodes of the same weights (the full
stage-2 re-regression, the stage-1 ROIs alone, all-zero deltas), and
rrnet_hrnetv2_attention (an RRNet) likewise;
centernet 400 steps, one decode; retinanet 1600 steps, one decode (no
host merge). `seed=S` among the overrides draws other weights,
permutations and samples; the set stays seed 219. `--int8-delta`
scores the same weights again with `Evaluator(quantize="int8")` (the
full decode; for an RRNet the stage-2 trunk quantizes with the backbone)
and writes an `int8` entry beside the row: AP, AP50, AP75, AR, the
number of quantized convs and `AP_delta_vs_bf16`.

Adds the run's row (APs, the train time and the share of it the step
loop spent waiting for batches, the seed, the card) to the rows already
in `--out` (one a run; a new file holds this run's row alone) and writes
each family's mean and spread over its runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import DevicePrefetcher, TrainLoader, ValLoader
from rrnet_torch.data.synth import make_synth_dataset
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.evallib.metrics import evaluate_results
from rrnet_torch.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_TRAIN, N_VAL, SEED = 32, 8, 219
_RRNET_DECODES = (("stage1_only", "stage1"), ("zero_delta", "zero"))
DECODES = {"rrnet": (("rrnet", "full"),) + _RRNET_DECODES,
           "centernet": (("centernet", "full"),),
           "retinanet": (("retinanet", "full"),),
           "rrnet_hrnetv2_attention": (("rrnet_hrnetv2_attention", "full"),)
           + _RRNET_DECODES}
STEPS = {"rrnet": 1600, "centernet": 400, "retinanet": 1600,
         "rrnet_hrnetv2_attention": 1600}
METRICS = ("AP", "AP50", "AP75", "AR")


def _card() -> Optional[str]:
    """nvidia-smi's name and power limit of the card, where there is one."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def run(args) -> dict:
    t0 = time.perf_counter()
    make_synth_dataset(args.dir, n_train=N_TRAIN, n_val=N_VAL, seed=SEED)
    synth_s = time.perf_counter() - t0
    print(f"# {N_TRAIN}+{N_VAL} synthetic images under {args.dir} in "
          f"{synth_s:.1f} s", file=sys.stderr)

    family = args.family
    steps = args.steps or STEPS[family]
    overrides = [f"data_root={args.dir}", f"train.batch_size={args.batch}",
                 f"train.iter_num={steps}", "val.scales=(1.0,)",
                 "val.flip_tta=False"]
    rrnet = cfglib.PRESETS[family]().model.name == "rrnet"
    if rrnet:
        # the reference gates stage 2 off for the first 2000 of 100k
        # steps; scaled to this schedule
        overrides.append(f"train.stage2_warmup_steps={steps // 4}")
    cfg = cfglib.apply_overrides(cfglib.PRESETS[family](),
                                 overrides + list(args.overrides))
    trainer = Trainer(cfg, device=args.device)
    state = trainer.init_state()
    train_loader = TrainLoader(cfg, args.batch)
    loader = DevicePrefetcher(train_loader, device=trainer.device)
    sync = (torch.cuda.synchronize if trainer.device.type == "cuda"
            else (lambda: None))

    sync()
    t0 = time.perf_counter()
    wait = 0.0
    metrics = None
    try:
        for step in range(steps):
            tw = time.perf_counter()
            batch = loader.get_batch()
            wait += time.perf_counter() - tw
            state, metrics = trainer.train_step(state, batch)
            if step % 100 == 99:
                print(f"# step {step + 1}: total="
                      f"{float(metrics['total']):.4f}", file=sys.stderr)
        total = float(metrics["total"])
        sync()
    finally:
        loader.close()
    train_s = time.perf_counter() - t0
    print(f"# trained {steps} steps in {train_s:.1f} s, {wait:.1f} s "
          f"waiting for batches, {train_loader.skips} loader skips (final "
          f"loss {total:.4f})", file=sys.stderr)

    model = trainer.model
    model.load_state_dict(state.state_dict())
    val_loader = ValLoader(cfg, split="val")
    gt_dir = os.path.join(args.dir, "val", "annotations")
    entry = {"family": family, "seed": cfg.seed,
             "device": {"type": trainer.device.type, "card": _card(),
                        "torch": torch.__version__},
             "train": {"steps": steps, "batch": args.batch,
                       "final_loss": total, "wall_s": train_s,
                       "wait_for_batches_s": wait,
                       "loader_share": wait / train_s,
                       "loader_skips": train_loader.skips}}
    if rrnet:
        entry["train"]["stage2_warmup_steps"] = steps // 4
    def score(tag, **ev_kwargs):
        ev = Evaluator(cfg, model, device=trainer.device, **ev_kwargs)
        result_dir = ev.evaluate_split(
            val_loader, result_dir=os.path.join(args.dir, f"results_{tag}"),
            batch_size=4, verbose=False)
        scores = evaluate_results(result_dir, gt_dir, verbose=False)
        row = {"AP": scores["ap"], "AP50": scores["ap50"],
               "AP75": scores["ap75"], "AR": scores["ar"]}
        if ev.quantize is not None:
            row["quantized_convs"] = len(ev._quant_scales)
        print(f"# {tag}: " + " ".join(f"{k}={v:.4f}" for k, v in row.items()),
              file=sys.stderr)
        return row

    for tag, decode in DECODES[family]:
        row = score(tag, stage2_decode=decode)
        if tag == family:
            entry.update(row)
        else:
            entry[tag] = row
    if args.int8_delta:
        row = score(f"{family}_int8", quantize="int8")
        row["AP_delta_vs_bf16"] = row["AP"] - entry["AP"]
        entry["int8"] = row
    return {
        "gate": "synthetic multi-image train->eval->AP",
        "dataset": {"n_train": N_TRAIN, "n_val": N_VAL, "seed": SEED,
                    "generator": "rrnet_torch/data/synth.py",
                    "seconds": synth_s},
        "eval_protocol": "single scale, no flip TTA, bucketed batch 4",
        "families": [entry],
    }


def summarize(entries) -> dict:
    """{family: {"seeds": [...], decode: {metric: {mean, min, max,
    spread, std}}}} over the rows (runs) of each family that has two or
    more (std: the sample standard deviation; a seed run twice counts
    twice)."""
    out = {}
    for family, decodes in DECODES.items():
        rows = [e for e in entries if e["family"] == family]
        if len(rows) < 2:
            continue
        fam = {"seeds": [e["seed"] for e in rows]}
        for tag, _ in decodes:
            picked = [e if tag == family else e[tag] for e in rows]
            stats = {}
            for k in METRICS:
                v = np.asarray([p[k] for p in picked], np.float64)
                stats[k] = {"mean": float(v.mean()), "min": float(v.min()),
                            "max": float(v.max()),
                            "spread": float(v.max() - v.min()),
                            "std": float(v.std(ddof=1))}
            fam[tag] = stats
        out[family] = fam
    return out


def merge(result: dict, path: str) -> dict:
    """`result`'s rows added to the gate file at `path` (if there is
    one), one row a run, sorted by family and seed (stable, so a seed run
    again follows its earlier run); the file's other keys are kept where
    `result` has none; then each family's summary over its runs."""
    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    rows = sorted(old.get("families", []) + result["families"],
                  key=lambda e: (list(DECODES).index(e["family"]), e["seed"]))
    return {**old, **result, "families": rows, "over_seeds": summarize(rows)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.synth_gate",
        description="Train a preset on the synthetic set and score its val "
                    "split.")
    ap.add_argument("--family", default="rrnet", choices=sorted(DECODES))
    ap.add_argument("--steps", type=int, default=None,
                    help="train steps (default: rrnet 1600, centernet "
                    "400, retinanet 1600, rrnet_hrnetv2_attention 1600)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dir", default=os.path.join(REPO, "build", "rrnet_synth"),
                    help="where the synthetic set and results are written")
    ap.add_argument("--out", default=os.path.join(REPO, "SYNTH_AP_torch.json"))
    ap.add_argument("--int8-delta", action="store_true",
                    help="also score the weights with quantize='int8' and "
                    "record the AP delta")
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)
    result = merge(run(args), args.out)
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
