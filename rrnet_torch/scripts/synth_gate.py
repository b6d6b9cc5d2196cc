"""Synthetic train -> eval -> AP gate for the rrnet family (port of
`scripts/synth_gate.py`'s rrnet row):

    python -m rrnet_torch.scripts.synth_gate [--steps 1600] [--batch 8]
        [--dir DIR] [--out SYNTH_AP_torch.json] [--device cuda] [key=value ...]

Makes the deterministic 32+8-image VisDrone-format set from the demo
fixture (`data.synth`, seed 219), trains the `rrnet` preset on it through
the whole input pipeline (`TrainLoader` -> `DevicePrefetcher` ->
`Trainer.train_step`) with stage 2 gated off for the first steps // 4,
then runs `Evaluator.evaluate_split` over the 8 val images (scale 1, no
flip, batch 4) and `evaluate_results` for three decodes of the same
weights: the full stage-2 re-regression, the stage-1 ROIs alone, and
all-zero deltas. Writes the APs, the train time and the share of it the
step loop spent waiting for batches to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

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
DECODES = (("rrnet", "full"), ("stage1_only", "stage1"),
           ("zero_delta", "zero"))


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

    overrides = [f"data_root={args.dir}", f"train.batch_size={args.batch}",
                 f"train.iter_num={args.steps}", "val.scales=(1.0,)",
                 "val.flip_tta=False",
                 # the reference gates stage 2 off for the first 2000 of
                 # 100k steps; scaled to this schedule
                 f"train.stage2_warmup_steps={args.steps // 4}"]
    cfg = cfglib.apply_overrides(cfglib.PRESETS["rrnet"](),
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
        for step in range(args.steps):
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
    print(f"# trained {args.steps} steps in {train_s:.1f} s, {wait:.1f} s "
          f"waiting for batches, {train_loader.skips} loader skips (final "
          f"loss {total:.4f})", file=sys.stderr)

    model = trainer.model
    model.load_state_dict(state.state_dict())
    val_loader = ValLoader(cfg, split="val")
    gt_dir = os.path.join(args.dir, "val", "annotations")
    entry = {"family": "rrnet",
             "train": {"steps": args.steps, "batch": args.batch,
                       "stage2_warmup_steps": args.steps // 4,
                       "final_loss": total, "wall_s": train_s,
                       "wait_for_batches_s": wait,
                       "loader_share": wait / train_s,
                       "loader_skips": train_loader.skips}}
    for tag, decode in DECODES:
        ev = Evaluator(cfg, model, device=trainer.device,
                       stage2_decode=decode)
        result_dir = ev.evaluate_split(
            val_loader, result_dir=os.path.join(args.dir, f"results_{tag}"),
            batch_size=4, verbose=False)
        scores = evaluate_results(result_dir, gt_dir, verbose=False)
        row = {"AP": scores["ap"], "AP50": scores["ap50"],
               "AP75": scores["ap75"], "AR": scores["ar"]}
        print(f"# {tag}: " + " ".join(f"{k}={v:.4f}" for k, v in row.items()),
              file=sys.stderr)
        if tag == "rrnet":
            entry.update(row)
        else:
            entry[tag] = row
    return {
        "gate": "synthetic multi-image train->eval->AP",
        "dataset": {"n_train": N_TRAIN, "n_val": N_VAL, "seed": SEED,
                    "generator": "rrnet_torch/data/synth.py",
                    "seconds": synth_s},
        "eval_protocol": "single scale, no flip TTA, bucketed batch 4",
        "device": {"type": trainer.device.type, "card": _card(),
                   "torch": torch.__version__},
        "families": [entry],
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.synth_gate",
        description="Train the rrnet preset on the synthetic set and score "
                    "its val split.")
    ap.add_argument("--steps", type=int, default=1600)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dir", default=os.path.join(REPO, "build", "rrnet_synth"),
                    help="where the synthetic set and results are written")
    ap.add_argument("--out", default=os.path.join(REPO, "SYNTH_AP_torch.json"))
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)
    result = run(args)
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
