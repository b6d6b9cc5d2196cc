"""Auto-eval: checkpoint sweep x threshold grid search (port of
`scripts/auto_eval.py`; reference scripts/RRNet/auto_eval.py:11-33 and
utils/metrics/metrics.py:254-305).

Two modes:

  * the threshold grid alone, on a directory of raw predictions:
        python -m rrnet_torch.scripts.auto_eval --pred results/ \\
            --gt data/DronesDET/val/annotations

  * the checkpoint sweep: raw predictions (`val.auto_test=True`) for
    every `ckp-N` under a log dir, written to `{ckpt_dir}/auto_eval_{N}`,
    each checkpoint loaded in place into one model behind one Evaluator,
    then the grid over each:
        python -m rrnet_torch.scripts.auto_eval --config centernet \\
            --ckpt-dir log/CenterNet --split val [--device cuda|cpu]

Each grid point filters the predictions by score, merges them by
per-class soft-NMS on the host and scores them
(`evallib.metrics.auto_evaluate_results`); the best point is printed last.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence, Tuple

from rrnet_torch import config as cfglib
from rrnet_torch.evallib.metrics import auto_evaluate_results


def sweep_checkpoints(args) -> Tuple[Dict[int, str], str]:
    """Raw predictions of every checkpoint under `args.ckpt_dir`; returns
    ({step: prediction dir}, the GT dir)."""
    from rrnet_torch.data.loader import ValLoader
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.scripts.eval import load_checkpoint, load_model
    from rrnet_torch.utils import checkpoint as ckpt

    cfg = cfglib.apply_overrides(cfglib.PRESETS[args.config](),
                                 args.overrides)
    # raw (unmerged) predictions, so that the grid owns the thresholds
    cfg = cfglib.set_by_path(cfg, "val.auto_test", True)
    steps = ckpt.available_steps(args.ckpt_dir)
    if not steps:
        sys.exit(f"no checkpoints under {args.ckpt_dir}")
    model, state = load_model(cfg, args.device)
    ev = Evaluator(cfg, model, device=args.device)
    loader = ValLoader(cfg, split=args.split)
    per_ckpt = {}
    for step in steps:
        load_checkpoint(model, state, args.ckpt_dir, step=step)
        out_dir = os.path.join(args.ckpt_dir, f"auto_eval_{step}")
        ev.evaluate_split(loader, result_dir=out_dir, batch_size=args.batch,
                          max_images=args.max_images, verbose=False)
        per_ckpt[step] = out_dir
        print(f"# ckp-{step}: raw predictions -> {out_dir}")
    gt = args.gt or os.path.join(cfg.data_root, args.split, "annotations")
    return per_ckpt, gt


def main(argv: Optional[Sequence[str]] = None):
    """Returns (best step or None, (score_thr, nms_thr), AP)."""
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.auto_eval",
        description="Score-threshold x soft-NMS-threshold grid over raw "
                    "predictions, for one directory or every checkpoint.")
    ap.add_argument("--pred", help="existing raw-prediction dir "
                                   "(threshold-grid-only mode)")
    ap.add_argument("--gt", help="GT annotation dir (defaults to "
                                 "<data_root>/<split>/annotations)")
    ap.add_argument("--config", default="centernet",
                    choices=sorted(cfglib.PRESETS))
    ap.add_argument("--ckpt-dir", help="sweep every ckp-N under this dir")
    ap.add_argument("--split", default="val")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--score-grid", type=float, nargs="+",
                    default=[0.01, 0.05, 0.1])
    ap.add_argument("--nms-grid", type=float, nargs="+",
                    default=[0.1, 0.3, 0.5])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu', for the sweep")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)

    if args.ckpt_dir:
        per_ckpt, gt = sweep_checkpoints(args)
    elif args.pred and args.gt:
        per_ckpt, gt = {None: args.pred}, args.gt
    else:
        sys.exit("need either --ckpt-dir (sweep mode) or --pred + --gt")

    best = (None, None, -1.0)
    for step, pred_dir in per_ckpt.items():
        for s in args.score_grid:
            for n in args.nms_grid:
                out = auto_evaluate_results(pred_dir, gt, s, n)
                tag = f"ckp-{step} " if step is not None else ""
                print(f"{tag}score_thr={s} nms_thr={n} AP={out['ap']:.4f}")
                if out["ap"] > best[2]:
                    best = (step, (s, n), out["ap"])
    tag = f"ckp-{best[0]} " if best[0] is not None else ""
    print(f"best: {tag}score_thr={best[1][0]} nms_thr={best[1][1]} "
          f"AP={best[2]:.4f}")
    return best


if __name__ == "__main__":
    main()
