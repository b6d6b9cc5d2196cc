"""Evaluation entry point (port of `scripts/eval.py`, reference
scripts/{RRNet,CTNet}/eval.py):

    python -m rrnet_torch.scripts.eval --config rrnet --ckpt log/TwoStageNet
        [--split val] [--max-images N] [--batch 4] [--no-score]
        [--quantize int8] [--data-parallel] [--device cuda|cpu]
        [--trace-dir DIR] [key=value ...]

Restores a checkpoint written by `python -m rrnet_torch.scripts.train`
(`--ckpt` is a log directory, whose newest `ckp-N` is taken, or a
`ckp-N` path), runs the preset's eval protocol over the split
(`val.scales`, flip TTA for CenterNet, the host soft-NMS merge when
`val.auto_test=False`), writes VisDrone result txts to `val.result_dir`
and scores them with the VisDrone AP evaluator. One card (or the CPU)
by default.
`--quantize int8` runs the body convolutions as int8
(`Evaluator(quantize="int8")`), calibrated on the first batch at every
protocol scale. `--data-parallel` splits each batch over every card of
the process (`Evaluator(devices=...)`, one model replica a card; the
CPU counts as one device), `--batch` rounded up to a multiple of their
count. `--trace-dir DIR` runs the split under one torch.profiler session
(`utils.tracing.profiled`) and writes `DIR/trace.json`, its Chrome trace
(host operators, device kernels and the port's spans), and
`DIR/spans.jsonl`, the spans and counters of the split
(`utils.tracing`), one JSON record a line.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import List, Optional, Sequence

import torch

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import ValLoader
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.evallib.metrics import evaluate_results
from rrnet_torch.models import build_model
from rrnet_torch.train.state import create_train_state
from rrnet_torch.utils import checkpoint as ckpt
from rrnet_torch.utils import tracing


def load_model(cfg: cfglib.Config, device: str, ckpt_path: Optional[str] = None,
               step: Optional[int] = None):
    """(model in eval mode on `device`, the CPU train-state template);
    the model holds the checkpoint's params and BN statistics when
    `ckpt_path` is given."""
    model = build_model(cfg, device=device)
    state = create_train_state(cfg, model, device="cpu")
    if ckpt_path is not None:
        load_checkpoint(model, state, ckpt_path, step)
    return model, state


def load_checkpoint(model: torch.nn.Module, state, ckpt_path: str,
                    step: Optional[int] = None) -> None:
    """Restore `ckpt_path` (a log dir and `step`, its newest, or a ckp-N
    path) into `state` and copy its weights into `model` in place."""
    ckpt.restore_checkpoint(ckpt_path, state, step=step)
    model.load_state_dict(state.state_dict())


def local_devices(device: str) -> List[str]:
    """The devices of `--data-parallel`: every card this process sees for
    a CUDA `device`, else `device` alone."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [device]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns {"result_dir": ..., "scores": AP dict or None}."""
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.eval",
        description="Evaluate a checkpoint with the preset's eval protocol.")
    ap.add_argument("--config", default="rrnet", choices=sorted(cfglib.PRESETS))
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint dir or ckp-N path")
    ap.add_argument("--split", default="val")
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4,
                    help="images per eval batch (per shape bucket)")
    ap.add_argument("--no-score", action="store_true",
                    help="skip the AP computation (txt files only)")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="int8 post-training quantization of the body "
                    "convolutions, calibrated on the first batch")
    ap.add_argument("--data-parallel", action="store_true",
                    help="split each batch over every card of the process "
                    "(one model replica a card); --batch is rounded up to a "
                    "multiple of their count")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--trace-dir", default=None,
                    help="profile the split: write DIR/trace.json (Chrome "
                    "trace) and DIR/spans.jsonl (the port's spans)")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)

    cfg = cfglib.apply_overrides(cfglib.PRESETS[args.config](),
                                 args.overrides)
    model, _ = load_model(cfg, args.device, args.ckpt)
    devices, batch = None, args.batch
    if args.data_parallel:
        devices = local_devices(args.device)
        batch = -(-batch // len(devices)) * len(devices)
    ev = Evaluator(cfg, model, device=args.device, quantize=args.quantize,
                   devices=devices)
    with (tracing.profiled(args.trace_dir) if args.trace_dir
          else contextlib.nullcontext()):
        result_dir = ev.evaluate_split(ValLoader(cfg, split=args.split),
                                       max_images=args.max_images,
                                       batch_size=batch)
    scores = None
    if not args.no_score:
        gt_dir = os.path.join(cfg.data_root, args.split, "annotations")
        scores = evaluate_results(result_dir, gt_dir)
    return {"result_dir": result_dir, "scores": scores}


if __name__ == "__main__":
    main()
