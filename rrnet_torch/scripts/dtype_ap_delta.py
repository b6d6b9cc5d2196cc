"""bf16-against-f32 AP delta (port of `scripts/dtype_ap_delta.py`):

    python -m rrnet_torch.scripts.dtype_ap_delta [--steps 600]
        [--config centernet] [--data DIR] [--out DTYPE_DELTA_torch.json]
        [--device cuda] [key=value ...]

The presets compute in bfloat16 (`model.dtype`) where the reference ran
float32. This harness trains the preset once on the demo fixture
(`data/demo`, batch 2) through the loader and the train step, then
evaluates the same weights (f32 parameters) with the compute dtype set
to bfloat16 and to float32, over the fixture's val split at the preset's
own protocol, and records both APs and their difference. The two evals
differ only in the precision of the activations and the arithmetic.

Writes the record to `--out` (never the JAX package's
`DTYPE_DELTA.json`) and prints the JAX package's TPU delta beside its
own where that file is in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import ValLoader
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.evallib.metrics import evaluate_results
from rrnet_torch.models import build_model
from rrnet_torch.scripts.stage2_ablation import train
from rrnet_torch.utils.device import device_record

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DTYPES = ("bfloat16", "float32")


def eval_ap(cfg, state_dict, dtype: str, device) -> dict:
    """AP, AP50, AP75 and AR of the weights over the val split with the
    compute dtype set to `dtype`."""
    cfg = cfglib.set_by_path(cfg, "model.dtype", dtype)
    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    ev = Evaluator(cfg, model, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        ev.evaluate_split(ValLoader(cfg, split="val"), result_dir=tmp,
                          verbose=False)
        out = evaluate_results(tmp, os.path.join(cfg.data_root, "val",
                                                 "annotations"),
                               verbose=False)
    return {k: float(out[k]) for k in ("ap", "ap50", "ap75", "ar")}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.dtype_ap_delta",
        description="Train on the demo fixture, then score the same "
                    "weights in bf16 and in f32.")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--config", default="centernet",
                    choices=sorted(cfglib.PRESETS))
    ap.add_argument("--data", default=os.path.join(REPO, "data", "demo"))
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "DTYPE_DELTA_torch.json"))
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    cfg = cfglib.apply_overrides(cfglib.PRESETS[args.config](), [
        f"data_root={args.data}", f"train.iter_num={args.steps}",
        "train.batch_size=2", *args.overrides])
    model, final_loss, train_s = train(cfg, args.steps, 2, args.device)
    state_dict = model.state_dict()
    device = next(model.parameters()).device
    result = {"config": args.config, "steps": args.steps, "batch": 2,
              "train_dtype": cfg.model.dtype, "final_loss": final_loss,
              "train_wall_s": train_s, "device": device_record(device)}
    for dtype in DTYPES:
        r = eval_ap(cfg, state_dict, dtype, device)
        result[dtype] = r
        print(f"{dtype}: AP={r['ap']:.4f} AP50={r['ap50']:.4f}",
              file=sys.stderr)
    for k in ("ap", "ap50"):
        result[f"{k}_delta_f32_minus_bf16"] = (result["float32"][k]
                                              - result["bfloat16"][k])
    result["jax_record"] = "DTYPE_DELTA.json (TPU v5e)"
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    line = f"# wrote {args.out}: delta(AP) = {result['ap_delta_f32_minus_bf16']}"
    jax_path = os.path.join(REPO, "DTYPE_DELTA.json")
    if os.path.exists(jax_path):
        with open(jax_path) as f:
            line += (f"   (TPU, JAX package: "
                     f"{json.load(f).get('ap_delta_f32_minus_bf16')})")
    print(line, file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
