"""A long synthetic training run, resumed half way, summarised (port of
`scripts/long_train_artifact.py`):

    python -m rrnet_torch.scripts.long_train_artifact --run WORK
        [--scale 1.0] [--device cuda] [--out LONG_TRAIN_torch.json]
        [key=value ...]
    python -m rrnet_torch.scripts.long_train_artifact --log-dir DIR
        --log-a A.log --log-b B.log [--scale 1.0] [--data DIR] ...

The schedule the gate (<= 1600 steps) never reaches, at `--scale` 1:
the `rrnet` preset at batch 8 on the synthetic set for 10,000 steps,
LR milestones 6000 and 8000 (x0.1), stage-2 warmup 2000, a checkpoint
every 2500 steps, and the run stopped at step 5000 and resumed from that
checkpoint in a second process. `--scale s` multiplies every one of
those step counts by s (0.25: 2500 steps, milestones 1500/2000,
checkpoints every 625, warmup 500, resumed from 1250).

`--run WORK` makes the synthetic set under WORK/synth and runs the two
train processes (`python -m rrnet_torch.scripts.train`), their output in
WORK/a.log and WORK/b.log and their log under WORK/log/RRNetLong. Then,
or given those three paths: parses the port's train log lines (`step N:
train/<name>_loss=<value> ...`, nan and inf included), refuses an A log
that resumed or a B log that did not, reads the LR the schedule applies
at the milestones, evaluates the last checkpoint on the val split (scale
1, no flip, batch 4) and writes `--out` (never the JAX package's
`LONG_TRAIN.json`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import ValLoader
from rrnet_torch.data.synth import make_synth_dataset
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.evallib.metrics import evaluate_results
from rrnet_torch.train import Trainer
from rrnet_torch.train.state import make_schedule
from rrnet_torch.utils import checkpoint as ckpt
from rrnet_torch.utils.device import device_record

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FULL = {"steps": 10000, "milestones": (6000, 8000), "checkpoint": 2500,
        "warmup": 2000, "resume": 5000}
LOG_PREFIX = "RRNetLong"
_LINE = re.compile(r"\bstep (\d+): (.*)$")
_LOSS = re.compile(r"train/(\w+)_loss=(\S+)")
_RESUMED = re.compile(r"resumed from step (\d+)")


def schedule(scale: float = 1.0) -> Dict:
    """The protocol's step counts multiplied by `scale` (each at least 1,
    the warmup at least 0)."""
    def s(n):
        return max(1, int(round(n * scale)))
    return {"steps": s(FULL["steps"]),
            "milestones": tuple(s(m) for m in FULL["milestones"]),
            "checkpoint": s(FULL["checkpoint"]),
            "warmup": int(round(FULL["warmup"] * scale)),
            "resume": s(FULL["resume"])}


def overrides(sched: Dict, data: str) -> List[str]:
    m1, m2 = sched["milestones"]
    return [f"data_root={data}", "train.batch_size=8",
            f"train.stage2_warmup_steps={sched['warmup']}",
            f"train.lr_milestones=({m1},{m2})",
            f"train.checkpoint_interval={sched['checkpoint']}"]


def parse_log(path: str) -> List[Dict]:
    """Every logged step of the port's train log: {"step", and each
    `train/<name>_loss` value by <name>}, in file order."""
    rows = []
    with open(path, errors="replace") as f:
        for line in f:
            m = _LINE.search(line)
            if m is None:
                continue
            losses = {k: float(v) for k, v in _LOSS.findall(m.group(2))}
            if losses:
                rows.append({"step": int(m.group(1)), **losses})
    return rows


def resumed_from(path: str) -> Optional[int]:
    """The step a train process's output says it resumed from (the last
    such line), or None."""
    step = None
    with open(path, errors="replace") as f:
        for line in f:
            m = _RESUMED.search(line)
            if m:
                step = int(m.group(1))
    return step


def run_training(work: str, sched: Dict, device: str,
                 extra: Sequence[str]) -> Dict[str, str]:
    """The two train processes of the protocol under `work`; returns the
    paths of their outputs, the log dir and the data."""
    data = make_synth_dataset(os.path.join(work, "synth"), n_train=32,
                              n_val=8, seed=219)
    log_root = os.path.join(work, "log")
    shutil.rmtree(log_root, ignore_errors=True)     # A must start fresh
    common = ["--config", "rrnet", "--device", device,
              *overrides(sched, data), f"log_dir={log_root}",
              f"log_prefix={LOG_PREFIX}", *extra]
    paths = {"log_a": os.path.join(work, "a.log"),
             "log_b": os.path.join(work, "b.log"),
             "log_dir": os.path.join(log_root, LOG_PREFIX), "data": data}
    for key, steps, more in (
            ("log_a", sched["resume"], []),
            ("log_b", sched["steps"], ["--resume", paths["log_dir"]])):
        cmd = [sys.executable, "-m", "rrnet_torch.scripts.train",
               "--steps", str(steps), *more, *common]
        t0 = time.perf_counter()
        with open(paths[key], "w") as out:
            rc = subprocess.run(cmd, cwd=REPO, stdout=out,
                                stderr=subprocess.STDOUT).returncode
        print(f"# {key}: {steps} steps, rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        if rc != 0:
            raise SystemExit(f"train process for {key} failed with rc {rc}; "
                             f"see {paths[key]}")
    return paths


def summarize(log_dir: str, log_a: str, log_b: str, data: str, sched: Dict,
              scale: float, device: str, extra: Sequence[str]) -> Dict:
    for name, path in (("--log-a", log_a), ("--log-b", log_b),
                       ("log.txt", os.path.join(log_dir, "log.txt"))):
        if not os.path.isfile(path):
            raise SystemExit(f"{name}: no such file {path}")
    fresh = resumed_from(log_a)
    if fresh is not None:
        raise SystemExit(f"--log-a resumed from step {fresh} but must be "
                         "the fresh run's output")
    resumed_at = resumed_from(log_b)
    if resumed_at is None:
        raise SystemExit("--log-b has no 'resumed from step' line: it must "
                         "be the resumed run's output")
    rows = parse_log(os.path.join(log_dir, "log.txt"))
    ckpts = ckpt.available_steps(log_dir)

    cfg = cfglib.apply_overrides(cfglib.rrnet_config(), [
        *overrides(sched, data), "val.scales=(1.0,)", "val.flip_tta=False",
        *extra])
    trainer = Trainer(cfg, device=device)
    state = ckpt.restore_checkpoint(log_dir, trainer.init_state())
    model = trainer.model
    model.load_state_dict(state.state_dict())
    ev = Evaluator(cfg, model, device=trainer.device)
    result_dir = ev.evaluate_split(
        ValLoader(cfg, split="val"), result_dir=os.path.join(
            os.path.dirname(log_dir), "results"), batch_size=4,
        verbose=False)
    scores = evaluate_results(result_dir, os.path.join(
        data, "val", "annotations"), verbose=False)

    lr = make_schedule(cfg)
    m1, m2 = sched["milestones"]
    points = sorted({0, sched["warmup"], m1 - 1, m1, m2 - 1, m2,
                     sched["steps"] - 1})
    every, early = max(1, int(1000 * scale)), int(400 * scale)
    track = [{"step": r["step"], "total": r.get("total"), "s2": r.get("s2")}
             for r in rows if (r["step"] + 1) % every == 0
             or r["step"] < early]
    cut = "" if scale == 1.0 else (
        f" (the 10k-step protocol with every step count x{scale})")
    return {
        "protocol": f"rrnet synthetic {sched['steps']}-step schedule{cut}, "
                    f"batch 8, stage-2 warmup {sched['warmup']}, LR "
                    f"milestones ({m1}, {m2}) x0.1, checkpoint every "
                    f"{sched['checkpoint']} steps, resumed from the step-"
                    f"{sched['resume']} checkpoint in a second process",
        "scale": scale,
        "schedule": {**sched, "milestones": list(sched["milestones"])},
        "device": device_record(trainer.device),
        "resumed_from_step": resumed_at,
        "checkpoints": ckpts,
        "final_step": int(state.step),
        "lr_schedule_points": {str(s): float(lr(torch.tensor(s)))
                               for s in points},
        "loss_track": track,
        "final_eval": {"AP": scores["ap"], "AP50": scores["ap50"],
                       "AP75": scores["ap75"], "AR": scores["ar"]},
        "eval_protocol": "val split of the synthetic set (8 images), scale "
                         "1, no flip, batch 4",
        "jax_record": "LONG_TRAIN.json (TPU v5e, 10k steps)",
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.long_train_artifact",
        description="Run or summarise the long resumed training schedule.")
    ap.add_argument("--run", metavar="WORK", default=None,
                    help="make the data and run both train processes here")
    ap.add_argument("--log-dir", help="the train log dir (log.txt, ckp-N)")
    ap.add_argument("--log-a", help="the fresh process's output")
    ap.add_argument("--log-b", help="the resumed process's output")
    ap.add_argument("--data", default=os.path.join(REPO, "build",
                                                   "rrnet_synth"))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every step count of the protocol")
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "LONG_TRAIN_torch.json"))
    ap.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides "
                    "for the train processes and the eval model")
    args = ap.parse_args(argv)
    sched = schedule(args.scale)
    if args.run:
        p = run_training(args.run, sched, args.device, args.overrides)
        log_dir, log_a, log_b, data = (p["log_dir"], p["log_a"], p["log_b"],
                                       p["data"])
    else:
        if not (args.log_dir and args.log_a and args.log_b):
            ap.error("give --run WORK, or --log-dir, --log-a and --log-b")
        log_dir, log_a, log_b, data = (args.log_dir, args.log_a, args.log_b,
                                       args.data)
    result = summarize(log_dir, log_a, log_b, data, sched, args.scale,
                       args.device, args.overrides)
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
