"""Where `rrnet_torch/csrc/hard_nms.cu`'s time goes on the card.

    python3 profile_hard_nms.py [--out FILE]

Builds the kernel as it ships (`rrnet_torch.ops.hard_nms`) and, beside
it, copies of its source with code patched in (`patched_source`; one
`nvcc` each, all started together, into build/hard_nms_<name>/):
  * rank: the mask and the scan cut out (its keep mask is wrong);
  * mask: the scan cut out (its keep mask is wrong);
  * stamps: thread 0 of the first 64 CTAs stamps clock64() at each phase,
    and the scanner at each step; the cluster size goes beside them.
On `chip_smoke.detections_like`'s candidates at B=1, 4 and 8, K=1500 per
class (thr 0.7; at B=1 also with the scores rounded to bf16, as a bf16
forward gives them) and `chip_smoke.retina_candidates_like`'s at B=4,
K=1000 (class-agnostic, thr 0.3, +1, a valid mask) it prints each build's
ms a call (CUDA events over 50 calls) and device ms (torch.profiler),
holds the shipped and the stamped builds' keep masks bit-equal to the
plain fixpoint, and prints the stamps' cycles a phase (mean and max over
the CTAs) and the scanner's cycles a step. Needs a CUDA device; the
card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import chip_smoke

SOURCE = (Path(__file__).resolve().parent / "rrnet_torch" / "csrc"
          / "hard_nms.cu")
PHASES = ("rank", "gather", "cluster wait", "mask", "scan", "keep")
STEP_SLOT, CLUSTER_SLOT, SLOTS = 16, 95, 96

# Each variant's edits: (text of the shipped source, what replaces it).
# Every text must occur exactly once, so an edit that no longer fits the
# source fails the build instead of timing something else.
CUT_MASK = ("  for (int k = me + C * warp; k < nblocks; k += C * kWarps) {",
            "  for (int k = me + C * warp; kStage >= 2 && k < nblocks;\n"
            "       k += C * kWarps) {")
CUT_SCAN = [
    ("  if (me == 0 && warp == 0) {\n    // 3a.",
     "  if (kStage >= 3 && me == 0 && warp == 0) {\n    // 3a."),
    ("  if (warp >= 1 && warp - 1 < nq) {",
     "  if (kStage >= 3 && warp >= 1 && warp - 1 < nq) {"),
    ("  if (warp == 0) {\n    // every block's keep bits",
     "  if (kStage >= 3 && warp == 0) {\n    // every block's keep bits"),
]


def stamp_before(text, slot):
    return (text, f"  STAMP({slot});\n{text}")


STAMPS = [
    ("  cluster_arrive();   // waited for",
     f"  STAMP(0);\n  STAMP_VALUE({CLUSTER_SLOT}, gridDim.x);\n"
     "  cluster_arrive();   // waited for"),
    stamp_before("  // the boxes, classes and valid flags in score order", 1),
    stamp_before("  cluster_wait();   // every CTA of the cluster", 2),
    stamp_before("  // 2. the mask: the W(W+1)/2 blocks", 3),
    stamp_before("  cluster_sync();   // every CTA's mask whole", 4),
    stamp_before("  __syncthreads();\n  // 4. keep, in input order", 5),
    stamp_before("  // No barrier before leaving", 6),
    ("      prev = kb;\n    };",
     f"      prev = kb;\n      STAMP({STEP_SLOT} + w);\n    }};"),
]
VARIANTS = {"rank": (1, False), "mask": (2, False), "stamps": (3, True)}


def patched_source(source: str, stage: int, stamps: bool) -> str:
    """`source` (hard_nms.cu's text) with the phases after `stage` cut out
    (1: after the rank and gather, 2: after the mask, 3: none) and, with
    `stamps`, the clock64 stamps and their C entry `rrnet_hard_nms_stamps`
    patched in."""
    edits = [CUT_MASK] + CUT_SCAN + (STAMPS if stamps else [])
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"hard_nms.cu holds {source.count(old)} copies "
                             f"of {old!r}; the profile's edits need one")
        source = source.replace(old, new)
    head = f"\nconstexpr int kStage = {stage};\n"
    if stamps:
        head += (
            f"__device__ long long g_stamps[64 * {SLOTS}];\n"
            "#define STAMP_VALUE(slot, v)                                \\\n"
            "  do {                                                      \\\n"
            "    const int cta_ = blockIdx.y * gridDim.x + blockIdx.x;   \\\n"
            "    if (threadIdx.x == 0 && cta_ < 64)                      \\\n"
            f"      g_stamps[cta_ * {SLOTS} + (slot)] = (v);              \\\n"
            "  } while (0)\n"
            "#define STAMP(slot) STAMP_VALUE(slot, clock64())\n"
            "extern \"C\" int rrnet_hard_nms_stamps(long long* out) {\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_stamps,\n"
            "                                   sizeof(g_stamps));\n"
            "}\n")
    include = "#include <cuda_runtime.h>\n"
    if source.count(include) != 1:
        raise ValueError("hard_nms.cu's include of cuda_runtime.h moved")
    return source.replace(include, include + head)


def build_variants(out_root: Path):
    """{variant: path of its library}, built together."""
    from rrnet_torch.utils import native
    source = SOURCE.read_text()

    def make(item):
        name, (stage, stamps) = item
        src = out_root / f"hard_nms_{name}"
        src.mkdir(parents=True, exist_ok=True)
        (src / "hard_nms.cu").write_text(patched_source(source, stage,
                                                        stamps))
        return name, native.build_all(("hard_nms",), src,
                                      src / "build")["hard_nms"]

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        return dict(ex.map(make, VARIANTS.items()))


def launcher(torch, path):
    """The C entry of the library at `path` with `hard_nms`'s arguments
    (the wrapper's checks left out; counts no launch), and the library."""
    from rrnet_torch.ops import hard_nms as hn
    lib = ctypes.CDLL(str(path))
    fn = hn.bind(lib)
    if lib.rrnet_hard_nms_setup() != 0:
        raise RuntimeError(f"{path}: setup failed")

    def run(boxes, scores, thr, valid=None, cls=None, plus_one=False):
        bsz, k = scores.shape
        keep = torch.empty((bsz, k), dtype=torch.bool, device=boxes.device)
        err = fn(boxes.data_ptr(), scores.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 None if cls is None else cls.data_ptr(), keep.data_ptr(),
                 bsz, k, thr, int(plus_one),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{path}: CUDA error {err}")
        return keep

    return run, lib


def inputs(torch):
    """{name: ((boxes, scores, thr, valid, class ids), plus_one)} on the
    card."""
    from rrnet_torch.models.retinanet import NMS_IOU
    rng = np.random.RandomState(15)
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a)).cuda())
    out = {}
    for b in (1, 4, 8):
        boxes, scores, cls = chip_smoke.detections_like(rng, b, 1500, 10)
        out[f"B={b} K=1500 per class"] = ((t(boxes), t(scores), 0.7, None,
                                          t(cls)), False)
        if b == 1:      # as a bf16 forward gives them: many ties
            tied = t(scores).bfloat16().float()
            out["B=1 K=1500 per class, bf16-valued scores"] = (
                (t(boxes), tied, 0.7, None, t(cls)), False)
    boxes, scores, valid = chip_smoke.retina_candidates_like(rng, 4, 1000)
    out["RetinaNet B=4 K=1000"] = ((t(boxes), t(scores), NMS_IOU, t(valid),
                                    None), True)
    return out


def stamps(torch, lib, run, call, plus_one):
    """The stamped build's cycles a phase (mean, max over the image's
    first CTAs, at most 64) and the scanner's mean cycles a step, from one
    call, and the CTAs an image."""
    lib.rrnet_hard_nms_stamps.argtypes = [ctypes.c_void_p]
    run(*call, plus_one=plus_one)
    torch.cuda.synchronize()
    st = np.zeros((64, SLOTS), np.int64)
    if lib.rrnet_hard_nms_stamps(st.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    bsz, k = call[1].shape
    ctas = int(st[0, CLUSTER_SLOT])
    ph = np.diff(st[:min(bsz * ctas, 64), :len(PHASES) + 1], axis=1)
    steps = np.diff(st[0, STEP_SLOT:STEP_SLOT + (k + 63) // 64])
    return ({n: [float(ph[:, i].mean()), float(ph[:, i].max())]
             for i, n in enumerate(PHASES)},
            float(steps.mean()) if len(steps) else 0.0, ctas)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the numbers as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_hard_nms needs a CUDA device")
    from rrnet_torch.ops import hard_nms as hn
    from rrnet_torch.utils import native
    card = chip_smoke.card_line()
    print(card, flush=True)
    native.build_all(("hard_nms",))
    libs = build_variants(Path(native.BUILD_DIR).parent)
    runs = {"shipped": (lambda *a, plus_one=False:
                        hn.hard_nms(*a, plus_one=plus_one), None)}
    runs.update({n: launcher(torch, p) for n, p in libs.items()})
    result = {"card": card, "ms": {}, "device_ms": {}, "cycles": {}}
    for label, (call, plus_one) in inputs(torch).items():
        want = hn.hard_nms_reference(*call, plus_one=plus_one)
        for name in ("shipped", "stamps"):
            if not torch.equal(runs[name][0](*call, plus_one=plus_one),
                               want):
                raise AssertionError(f"{name} differs from the plain "
                                     f"fixpoint at {label}")
        row_ms, row_dev = {}, {}
        for name, (run, _) in runs.items():
            fn = (lambda r=run: r(*call, plus_one=plus_one))
            row_ms[name] = chip_smoke.cuda_ms(fn, reps=50)
            row_dev[name] = sum(chip_smoke.device_split(torch, fn,
                                                        reps=20).values())
        result["ms"][label] = row_ms
        result["device_ms"][label] = row_dev
        print(f"{label}: " + ", ".join(
            f"{n} {row_ms[n]:.4f} ms (device {row_dev[n]:.4f})"
            for n in runs), flush=True)
        phases, step, ctas = stamps(torch, runs["stamps"][1],
                                    runs["stamps"][0], call, plus_one)
        result["cycles"][label] = {"ctas_an_image": ctas, "phases": phases,
                                   "scanner_step": step}
        print(f"  {ctas} CTAs an image; cycles a phase (mean / max over "
              "CTAs): " + ", ".join(f"{n} {m:.0f} / {x:.0f}"
                                    for n, (m, x) in phases.items())
              + f"; the scanner's step {step:.0f}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
