"""The benchmark of `rrnet_torch` on one NVIDIA card.

    python3 -m rrbench.run --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. One cell of `BENCHMARK.json` a process:
set-up (weights and inputs from the seed, warm-up of the cell's own
shapes), the window of `--seconds`, then, with `--trace 1`, a traced
stretch, then the check of what the window produced against the plain
reference. The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the end-to-end metrics, or
with `--trace 1` the per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number with its limit. The
same numbers are the last lines of standard error. Without a CUDA card,
with fewer cards than the cell asks for, or with JAX, flax or the JAX
package loaded, it prints no result and exits with another code than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from rrbench import harness  # noqa: E402


def result(cell, rec, setup_s: float) -> dict:
    """The result line of a finished run, `checks` last."""
    import torch
    from rrbench import trace
    judged = harness.judge(rec["numbers"], cell.limits)
    metrics = harness.metrics_of(cell, rec)
    if not cell.trace:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device = {"platform": "gpu",
              "kind": torch.cuda.get_device_name(cell.device),
              "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": rec["failed"] == 0 and all(
               j["ok"] for j in judged.values()),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    tr = rec.get("trace")
    if tr is not None:
        device["busy_s"] = trace.busy_s(tr)
        device["window_s"] = trace.window_s(tr)
        out["breakdown"] = {"device_ops": trace.device_ops(tr),
                            "idle_gaps": trace.idle_by_host(tr)}
    out["checks"] = {k: {"value": j["value"], "limit": j["limit"]}
                     for k, j in judged.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("rrbench: no CUDA card; no result", file=sys.stderr)
        return 2
    man = harness.manifest()
    cell = harness.Cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", man=man)
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"rrbench: {cell.name} asks for {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} here; no result",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    print(f"rrbench: {cell.name} seed {args.seed} on "
          f"{harness.card()}, torch {torch.__version__}", file=sys.stderr,
          flush=True)
    setup = {}
    rec = cell.driver().run(cell, setup_done=lambda: setup.setdefault(
        "s", time.perf_counter() - T_START))
    bad = harness.forbidden_modules()
    if bad:
        print(f"rrbench: loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 4
    print(f"rrbench: setup_s {setup['s']!r}, window {rec['window_s']!r} s",
          file=sys.stderr)
    if rec.get("look"):
        print(f"rrbench: beside the checks {json.dumps(rec['look'])}",
              file=sys.stderr)
    out = result(cell, rec, setup["s"])
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
