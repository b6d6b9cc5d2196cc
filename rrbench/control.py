"""The controls of the comparison: readings that `correct` must refuse.

    python3 -m rrbench.control --workload NAME --seeds 11,12,13

For each seed it makes the cell's weights and inputs as a run does and
reads the cell's compared numbers for:

  * `fp8`: the reference in the program's place, its convolutions and
    dense layers on inputs and weights rounded to float8 e4m3 (one
    precision below the bfloat16 the configurations state), judged by
    the float32 reference as a run judges the port: four frames at the
    traffic's scales, stage by stage.

One JSON line a seed. The benchmark's runs do not run it; it sets the
upper readings of `rrbench/checks/<workload>.json`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from rrbench import harness
from rrbench.frames import frames
from rrbench.reference import pipeline
from rrbench.reference.layers import set_fp8
from rrbench.reference.model import build_rrnet


def _shapes_module(cell):
    with torch.device("meta"):
        return build_rrnet(cell.arch())


def detection_controls(cell, frames_checked: int = 4) -> dict:
    """The float8 reference in the port's place on `frames_checked`
    frames of the pool: each scale's forward judged by the float32
    reference as a run judges the port's (`drivers.detect.judge`)."""
    from rrbench.drivers import detect
    tr = cell.traffic
    weights = cell.weights_for(_shapes_module(cell))
    val = cell.config["val"]
    pool = frames(cell.seed, tr["pool"], tuple(tr["frame_hw"]))
    pool = pool[:frames_checked]
    ref, low = cell.reference(weights), set_fp8(cell.reference(weights))
    numbers = []
    for f in pool:
        _, bucket, fwds = pipeline.forwards(
            low, f, val["scales"], val["mean"], val["std"], val["transport"],
            tr["bucket_multiple"])
        rows = pipeline.sort_rows([pipeline.rows_of(w, 0, bucket)
                                   for w in fwds])
        got, _ = detect.judge(ref, cell.port_config(), [f], fwds, [rows],
                              tr["bucket_multiple"])
        numbers.append(got)
    return {"fp8": {k: max(n[k] for n in numbers) for k in numbers[0]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rrbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = harness.Cell(args.workload, seed, 0, False, "cuda")
        out = detection_controls(cell)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
