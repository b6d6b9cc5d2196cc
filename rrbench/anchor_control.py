"""The float8 control of an anchor-based cell (`drivers.anchor_eval`): a
reading that `correct` must refuse.

    python3 -m rrbench.anchor_control --workload NAME --seeds 11,12,13

For each seed it makes the cell's weights and inputs as a run does and
reads the cell's compared numbers for `fp8`: the reference in the
program's place, its convolutions on inputs and weights rounded to
float8 e4m3 (one precision below the bfloat16 the configuration
states), judged by the float32 reference as a run judges the port
(`drivers.anchor_eval.controls`). One JSON line a seed. The benchmark's
runs do not run it; it sets the upper readings of
`rrbench/checks/<workload>.json`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from rrbench import harness
from rrbench.drivers import anchor_eval


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rrbench.anchor_control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = harness.Cell(args.workload, seed, 0, False, "cuda")
        out = anchor_eval.controls(cell)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
