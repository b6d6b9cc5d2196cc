#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--before DIR]

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit from nvidia-smi, whether
     PIL and OpenCV import and where nvJPEG lies under the toolkit, and
     PyTorch's TF32 settings, which the run leaves at their defaults
     (the port pins its f32 convolutions to f32 itself);
  2. build: every CUDA kernel of the port from `rrnet_torch/csrc/`, one
     `nvcc` per source, all started together; ptxas register and spill
     lines;
  3. kernels: each kernel against its plain PyTorch version on the card
     at its path's shapes, plus edge cases, and timed against its bound;
     the serial soft-NMS timed class-agnostic at B=4 and B=1 and per
     class at B=4 with its selections per image (one pick, one barrier a
     step), and per class and class-agnostic at B=4 built with at most 8,
     16 and 24 warps a block; the class-parallel soft-NMS also against the
     serial kernel,
     with the busiest class's chain length per image beside its time; hard
     NMS against the plain fixpoint; the DCN kernels against both bound
     routes (f32 on the CUDA cores, 3xTF32 on the tensor cores), the
     backward's two kernels apart. `--before DIR` builds another version
     of the sources that DIR holds (the DCN trio, `soft_nms_classes.cu`,
     `soft_nms.cu`) and times it beside this checkout's, in turns
     ("before/after" lines);
  4. small-input reference: a tiny RRNet (hard NMS and soft-NMS), a tiny
     RRNet train step (soft-NMS; hard NMS with the card's stage 2 fed the
     CPU's ROIs bit for bit) and trires50deform at 64x64, all f32, on the
     card against the same models on the CPU (the path the CPU tests hold
     to the JAX package);
  5. main path: `rrnet_torch.serving.Predictor` on the flagship `rrnet`
     preset at its defaults (stage-1 hard NMS; hourglass-104, 2 stacks,
     topk 1500, 512 ROIs, bf16, seeded random weights) answers single
     requests and one batch inside the 768x1408 bucket; then the same
     model and weights with per-class soft-NMS (the class-parallel
     kernel), then with class-agnostic soft-NMS (the serial kernel). For
     each setting the launch counts of its run are read
     back, one request's ROI selection is redone with the plain version,
     and `select_rois` runs once under `torch.cuda.set_sync_debug_mode(
     "error")`; the serial kernel is timed on that request's candidates;
  6. trident path: `build_backbone("trires50deform")` (full width, f32 at
     PyTorch's TF32 defaults, seeded weights with nonzero offset/mask
     convs) serves eval forwards at 1x3x768x1408 and takes train steps
     (batch statistics, backward of a seeded loss) at 4x3x512x512; the
     DCN launch counts of that run are read back (15 forward launches a
     forward, 15 backward launches a step); l1..l4 and the running
     statistics are held to the same model with the plain DCN, and every
     DCN-touching gradient to the plain DCN's backward behind the
     kernels' forward (an all-plain step's f32 gradients differ by the
     ReLUs and sample coordinates that flip between two forwards; that
     comparison is printed);
  7. train path: `rrnet_torch.train.Trainer` on the flagship preset at
     full width at its defaults (bf16, stage-1 hard NMS; stage 2 from
     step 0) takes 10 steps on one seeded batch of 4 uint8 512x512 crops
     (one hard-NMS launch a forward, a falling total), then a batch of
     inf pixels that must leave the whole state bitwise as it was; one
     step's own decoded candidates are selected again by the plain
     fixpoint (the step's ROIs), and by the class-parallel and the serial
     soft-NMS kernels (the same ROIs);
  8. data and eval path: the JPEG route (PIL) against a recorded decode
     of the demo frame, the synthetic set (32+8 images,
     seed 219), `TrainLoader` alone at the preset's defaults (samples/s),
     20 train steps at batch 4 through `TrainLoader` -> `DevicePrefetcher`
     -> `Trainer.train_step` (step p50, the wait on `get_batch`, loader
     skips, hard-NMS launches), a checkpoint restored bitwise into a fresh
     Trainer, `Evaluator.evaluate_split` over the 8 val images held to
     `predict_batch` and scored by `evaluate_results`, and its throughput
     on 16 frames of 765x1360 at batch 4.
Each path runs with every launch count set to 0 just before it and read
just after. Then a JSON line holds the data path's numbers, one lists every kernel,
and the last line is the result. It exits non-zero without a result when no CUDA device is
present.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Roofline of one H100 SXM at its 700 W limit (NVIDIA H100 Tensor Core
# GPU data sheet, SXM5, dense rates).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12       # tensor cores, TF32 inputs, f32 accumulate
# f32 operations of a soft-NMS step. Per candidate slot (active,
# unselected): the argmax compare, iw and ih (min, max, sub, add each) and
# the two overlap tests. Per candidate slot that overlaps the pick (the
# others keep their score: weight 1): the two clamps, inter, the union
# (add, sub, clamp), the divide, the gaussian weight (mul, div, exp), the
# decay multiply and the threshold compare.
SOFT_NMS_OPS_PER_OPEN_SLOT = 11
SOFT_NMS_OPS_PER_OVERLAP = 12
# f32 operations per box pair of hard NMS, counted as for soft-NMS: IoU
# (min/max/sub/add on both axes, clamps, inter, union, clamp, divide),
# the class compare and select, and the threshold compare.
HARD_NMS_OPS_PER_PAIR = 18
# f32 operations of DCNv2 beside its GEMMs. Per (position, tap, channel):
# the forward's bilinear sample (4 mul, 3 add) and mask multiply; the
# backward's recomputed sample (7), masked sample for grad weight (1),
# grad mask (mul, add), g_s (1), the y and x coordinate derivatives
# (2 sub, 2 mul, 1 add, 1 mul, 1 add each) and the four corner
# scatters (mul, add each). Per (position, tap, group): the sample's
# coordinates, floor, lerp weights and corner tests, ~30.
DCN_FWD_OPS_PER_SAMPLE_CHANNEL = 8
DCN_BWD_OPS_PER_SAMPLE_CHANNEL = 33
DCN_OPS_PER_SAMPLE = 30


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def jpeg_probe():
    """Print whether PIL and cv2 import here, and where nvJPEG's library
    and header lie under the toolkit that `nvcc` belongs to."""
    import importlib
    from pathlib import Path
    for mod in ("PIL", "cv2"):
        try:
            m = importlib.import_module(mod)
            print(f"  {mod}: imports, {getattr(m, '__version__', '?')}",
                  flush=True)
        except ImportError as e:
            print(f"  {mod}: does not import ({e})", flush=True)
    from rrnet_torch.utils import native
    home = os.path.dirname(os.path.dirname(os.path.realpath(native._nvcc())))
    libs = sorted(str(p) for d in ("lib64", "targets/x86_64-linux/lib")
                  for p in Path(home, d).glob("libnvjpeg*"))
    heads = sorted(str(p) for d in ("include", "targets/x86_64-linux/include")
                   for p in Path(home, d).glob("nvjpeg.h"))
    print(f"  toolkit {home}: nvJPEG libraries {libs or 'none'}; header "
          f"{heads or 'none'}", flush=True)


def cuda_ms(fn, reps, warm=2):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def detections_like(rng, b, k, n_cls, frame_hw=(192, 352)):
    """Candidates shaped like decoded stage-1 detections on a 192x352
    feature frame: clusters of jittered boxes around ~k/10 objects, so
    that many overlap, with CenterNet-like skewed scores."""
    fh, fw = frame_hw
    n_obj = max(1, k // 10)
    boxes = np.empty((b, k, 4), np.float32)
    cls = np.empty((b, k), np.int32)
    for i in range(b):
        cy = rng.rand(n_obj) * fh
        cx = rng.rand(n_obj) * fw
        size = rng.uniform(1.5, 24.0, (n_obj, 2))
        obj = rng.randint(0, n_obj, k)
        ocls = rng.randint(0, n_cls, n_obj)
        jit = rng.randn(k, 2) * 0.15 * size[obj]
        wh = size[obj] * np.exp(rng.randn(k, 2) * 0.1)
        ctr = np.stack([cx[obj], cy[obj]], 1) + jit
        boxes[i] = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1)
        cls[i] = np.where(rng.rand(k) < 0.9, ocls[obj],
                          rng.randint(0, n_cls, k))
    scores = rng.beta(0.6, 2.5, (b, k)).astype(np.float32)
    return boxes, scores, cls


def soft_nms_library(torch, lib, label):
    """The serial soft-NMS B.1 of the built library `lib` (its C entry
    `rrnet_soft_nms`), taking the arguments of `soft_nms` and doing the
    same work around the launch as the wrapper, so that two builds are
    timed on equal terms. It counts no launch."""
    import ctypes
    from rrnet_torch.ops.nms import _METHODS
    fn = ctypes.CDLL(str(lib)).rrnet_soft_nms
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(boxes, scores, valid, cls, *, sigma=0.5, iou_threshold=0.3,
            score_threshold=0.001, method="gaussian", max_out=None):
        bsz, k = scores.shape
        steps = k if max_out is None else min(max_out, k)
        dev = boxes.device
        out = (torch.empty((bsz, k), dtype=torch.float32, device=dev),
               torch.empty((bsz, k), dtype=torch.bool, device=dev),
               torch.empty((bsz, k), dtype=torch.int32, device=dev))
        err = fn(boxes.data_ptr(), scores.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 None if cls is None else cls.data_ptr(),
                 *(o.data_ptr() for o in out), bsz, k, steps,
                 _METHODS[method], sigma, iou_threshold, score_threshold,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"soft_nms ({label}) launch failed: CUDA "
                               f"error {err}")
        return out

    return run


def before_soft_nms(torch, src):
    """B.1 built from another version of `soft_nms.cu` in `src` (e.g. the
    parent commit's) into src/build (`soft_nms_library`)."""
    from pathlib import Path
    from rrnet_torch.utils import native
    src = Path(src)
    lib = native.build_all(("soft_nms",), src, src / "build")["soft_nms"]
    return soft_nms_library(torch, lib, str(src))


def soft_nms_caps(torch, caps=(8, 16, 24)):
    """This checkout's B.1 built with at most `w` warps a block for each
    `w` of `caps` (`-DRRNET_SOFT_NMS_MAX_WARPS=w`, into build/
    soft_nms_warps<w>, the builds started together), for the timing that
    chose the kernel's cap. Returns {w: soft_nms_library}, and prints each
    build's register and spill lines."""
    from concurrent.futures import ThreadPoolExecutor
    from rrnet_torch.utils import native

    def build(w):
        out = native.BUILD_DIR.parent / f"soft_nms_warps{w}"
        lib = native.build_all(("soft_nms",), native.CSRC, out,
                               (f"-DRRNET_SOFT_NMS_MAX_WARPS={w}",))
        for line in (out / "soft_nms.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  soft_nms at most {w} warps: {line.strip()}",
                      flush=True)
        return lib["soft_nms"]

    with ThreadPoolExecutor(len(caps)) as ex:
        libs = list(ex.map(build, caps))
    return {w: soft_nms_library(torch, lib, f"at most {w} warps")
            for w, lib in zip(caps, libs)}


def soft_nms_cases(rng):
    """(name, boxes, scores, valid, cls, settings) of B.1 on the card:
    the detections-like main shapes and edge cases."""
    boxes, scores, cls = detections_like(rng, 4, 1500, 10)
    mask = rng.rand(4, 1500) > 0.1
    extra = np.random.RandomState(17)   # `rng` moves as it always did
    big_b, big_s, _ = detections_like(extra, 1, 4096, 10)
    eb, es, ec = boxes[:1, :300], scores[:1, :300], cls[:1, :300]
    ident = np.tile(np.array([[[10, 10, 20, 20]]], np.float32), (1, 64, 1))
    # zero, -0 and negative scores among positive ones
    signed = scores[:, :600] - 0.3
    signed[:, ::7] = 0.0
    signed[:, 3::11] = -0.0
    # x2 < x1 or y2 < y1 for a third of the boxes
    degen = boxes[:, :600].copy()
    flip = extra.rand(4, 600) < 0.33
    degen[flip] = degen[flip][:, [2, 3, 0, 1]]
    g = dict(method="gaussian", sigma=0.5, max_out=512)
    return [
        ("main B=4 K=1500 per-class", boxes, scores, None, cls, g),
        ("K=1", boxes[:, :1], scores[:, :1], None, cls[:, :1], g),
        ("all invalid", boxes[:, :40], scores[:, :40],
         np.zeros((4, 40), bool), cls[:, :40], g),
        ("identical boxes", ident, np.linspace(1, .2, 64)[None]
         .astype(np.float32), None, None, g),
        ("equal scores", eb, np.full_like(es, 0.5), None, ec, g),
        ("max_out above survivors", boxes[:, :200], scores[:, :200], None,
         cls[:, :200], dict(g, max_out=4000)),
        ("class-agnostic with valid mask", boxes, scores, mask, None, g),
        ("class-agnostic B=4 K=1500", boxes, scores, None, None, g),
        ("class-agnostic B=1 K=1500", boxes[:1], scores[:1], None, None, g),
        ("class-agnostic K=4096", big_b, big_s, None, None, g),
        ("zero and negative scores", boxes[:, :600], signed, None,
         cls[:, :600], g),
        ("zero and negative scores, class-agnostic", boxes[:, :600], signed,
         None, None, g),
        ("degenerate boxes", degen, scores[:, :600], None, None, g),
        ("sigma -0.5 (weights above 1: no skip)",
         boxes[:, :600], scores[:, :600], None, cls[:, :600],
         dict(g, sigma=-0.5)),
        ("linear", boxes, scores, None, None, dict(g, method="linear")),
        ("hard, threshold -0.1 (no skip)", boxes[:, :600], scores[:, :600],
         None, cls[:, :600], dict(g, method="hard", iou_threshold=-0.1)),
        ("max_out 37, per-class", boxes, scores, None, cls,
         dict(g, max_out=37)),
        ("max_out 3, class-agnostic", boxes, scores, None, None,
         dict(g, max_out=3)),
    ]


def check_soft_nms(torch, sn, rng):
    """B.1 against its plain version on the card, every case through the
    wrapper: keep and rank equal, kept scores within rtol 1e-5. Returns
    (max |kept score diff| of the main case, the cases)."""
    dev = torch.device("cuda")
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    base = dict(iou_threshold=0.7, score_threshold=0.1)
    cases = soft_nms_cases(rng)
    main_err = None
    for name, b, s, v, c, settings in cases:
        args = (t(b), t(s), t(v), t(c))
        kw = dict(base, **settings)
        got = sn.soft_nms(*args, **kw)
        torch.cuda.synchronize()
        ref = sn.soft_nms_reference(*args, **kw)
        k = ref[1]
        if not (torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])):
            raise AssertionError(f"soft_nms kernel: keep/rank differ ({name})")
        torch.testing.assert_close(got[0][k], ref[0][k], rtol=1e-5, atol=0)
        err = float((got[0][k] - ref[0][k]).abs().max()) if k.any() else 0.0
        print(f"  soft_nms {name}: keep {int(k.sum())} equal, rank equal, "
              f"max |score diff| {err:.3g}; selections {k.sum(1).tolist()}",
              flush=True)
        if main_err is None:
            main_err = err
    return main_err, cases


def soft_nms_bound(sn, args, kw):
    """B.1's bound on these inputs: the larger of its bytes (each input
    read once, each output written once) over the HBM rate and the f32
    operations this data needs (each step's open slots, and the decay of
    those that overlap the pick) over the f32 rate. Returns (bound ms,
    "operations" or "bytes", {open, overlapping slot-steps per image,
    ops, bytes})."""
    work = sn.soft_nms_reference(*args, return_work=True, **kw)[3]
    bsz, kk = args[1].shape
    ops = (float(work[:, 0].sum()) * SOFT_NMS_OPS_PER_OPEN_SLOT
           + float(work[:, 1].sum()) * SOFT_NMS_OPS_PER_OVERLAP)
    nbytes = bsz * kk * ((16 + 4 + 4) + (4 + 1 + 4))
    bound_ops = ops / F32_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(bound_ops, bound_bytes),
            "operations" if bound_ops >= bound_bytes else "bytes",
            {"open_slot_steps": work[:, 0].tolist(),
             "overlap_slot_steps": work[:, 1].tolist(), "ops": ops,
             "bytes": nbytes})


def time_soft_nms(torch, sn, label, args, kw, card, before=None,
                  caps=None):
    """B.1 on one input (tensors on the card): the wrapper a call over 50
    back-to-back calls and its device time (torch.profiler), the parent's
    build (`before`) in turns (before, after, after, before), and with
    `caps` ({warps: build}, `soft_nms_caps`) each cap's build; the
    selections (chain length; one pick and one barrier a step) per image,
    the plain version's time and the bound. Returns the numbers as a
    dict."""
    out = sn.soft_nms(*args, **kw)
    sel = out[1].sum(1).tolist()
    if before is not None:
        old = before(*args, **kw)
        if not all(torch.equal(a, b) for a, b in zip(old, out)):
            raise AssertionError(f"soft_nms {label}: the --before build "
                                 "differs from this one")
    versions = {"after": lambda: sn.soft_nms(*args, **kw)}
    if before is not None:
        versions["before"] = lambda: before(*args, **kw)
    order = ["before", "after", "after", "before"] if before else ["after"]
    times = {v: [] for v in versions}
    for v in order:
        times[v].append(cuda_ms(versions[v], reps=50))
    ms = {v: float(np.mean(x)) for v, x in times.items()}
    device = {v: sum(device_split(torch, f, reps=20).values())
              for v, f in versions.items()}
    plain_ms = cuda_ms(lambda: sn.soft_nms_reference(*args, **kw), reps=3,
                       warm=1)
    bound, bound_by, work = soft_nms_bound(sn, args, kw)
    longest = max(max(sel), 1)
    print(f"  soft_nms timing, {label}, on {card}: wrapper {ms['after']:.4f}"
          f" ms a call (device {device['after']:.4f} ms, "
          f"{device['after'] / longest * 1e3:.3f} us a step of the longest "
          f"chain), plain {plain_ms:.2f} ms, bound {bound:.6f} ms "
          f"({bound_by}; open slot-steps per image "
          f"{work['open_slot_steps']}, of them overlapping the pick "
          f"{work['overlap_slot_steps']}, {work['ops']:.0f} ops, "
          f"{work['bytes']} bytes); selections per image {sel} (= barrier "
          "rounds: one pick a step); no PyTorch call computes soft-NMS, so "
          "library_ms is null", flush=True)
    if before is not None:
        print(f"  soft_nms before/after, {label}, on {card}: "
              f"{ms['before']:.4f} -> {ms['after']:.4f} ms a call "
              f"({ms['before'] / ms['after']:.2f}x); device "
              f"{device['before']:.4f} -> {device['after']:.4f} ms "
              f"({device['before'] / device['after']:.2f}x); "
              f"{device['before'] / longest * 1e3:.3f} -> "
              f"{device['after'] / longest * 1e3:.3f} us a step of the "
              f"longest chain ({longest}) (each the mean of two timings, "
              "before, after, after, before)", flush=True)
    result = {"ms": ms["after"], "device_ms": device["after"],
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
              "selections": sel, **work}
    if before is not None:
        result.update(before_ms=ms["before"],
                      before_device_ms=device["before"])
    if caps:
        by_cap = {}
        for w, run in caps.items():
            got = run(*args, **kw)
            if not all(torch.equal(a, b) for a, b in zip(got, out)):
                raise AssertionError(f"soft_nms {label}: the build with at "
                                     f"most {w} warps differs")
            by_cap[w] = cuda_ms(lambda: run(*args, **kw), reps=50)
        print(f"  soft_nms {label}, built with at most "
              + " / ".join(str(w) for w in by_cap) + " warps: "
              + " / ".join(f"{x:.4f}" for x in by_cap.values())
              + " ms a call", flush=True)
        result["ms_by_max_warps"] = by_cap
    return result


def soft_nms_timings(torch, sn, cases, card, before=None):
    """B.1 timed on the detections-like inputs: class-agnostic at B=4 and
    B=1 (the path the model takes), per class at B=4 (the row of earlier
    PRs); the cap's builds at B=4. Returns the kernel's line without its
    launches."""
    dev = torch.device("cuda")
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    kw = dict(sigma=0.5, iou_threshold=0.7, score_threshold=0.1,
              method="gaussian", max_out=512)
    named = {c[0]: c for c in cases}
    caps = soft_nms_caps(torch)
    rows = {}
    for key, case in (("per_class_b4", "main B=4 K=1500 per-class"),
                      ("class_agnostic_b4", "class-agnostic B=4 K=1500"),
                      ("class_agnostic_b1", "class-agnostic B=1 K=1500")):
        _, b, s, v, c, _ = named[case]
        rows[key] = time_soft_nms(
            torch, sn, case, (t(b), t(s), t(v), t(c)), kw, card, before,
            caps if key != "class_agnostic_b1" else None)
    main = rows["per_class_b4"]
    return {"name": "soft_nms", "route": "cuda",
            "source": "rrnet_torch/csrc/soft_nms.cu",
            "replaces": "rrnet_tpu/ops/pallas_nms.py:45",
            "launches": None, "max_abs_err": None, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": "B=4 K=1500 per class, max_out 512", **{
                k: v for k, v in main.items() if k not in (
                    "ms", "plain_ms", "bound_ms", "bound_by")},
            "class_agnostic": rows["class_agnostic_b4"],
            "class_agnostic_b1": rows["class_agnostic_b1"]}


def classes_inputs(torch, rng):
    """(cases, main args) of the class-parallel soft-NMS on the card: each
    case (name, boxes, scores, valid, cls, settings)."""
    boxes, scores, cls = detections_like(rng, 4, 1500, 10)
    mask = rng.rand(4, 1500) > 0.2
    big_b, big_s, big_c = detections_like(rng, 2, 4096, 10)
    g = dict(method="gaussian", max_out=512)
    cases = [
        ("main B=4 K=1500 10 classes", boxes, scores, None, cls, g),
        ("K=1", boxes[:, :1], scores[:, :1], None, cls[:, :1], g),
        ("all invalid", boxes[:, :40], scores[:, :40],
         np.zeros((4, 40), bool), cls[:, :40], g),
        ("single class", boxes[:, :300], scores[:, :300], None,
         np.full((4, 300), 4, np.int32), g),
        ("single class K=1500 (6 warps)", boxes, scores, None,
         np.full((4, 1500), 7, np.int32), g),
        ("single class K=4096 (8 warps)", big_b, big_s, None,
         np.full((2, 4096), 0, np.int32), g),
        ("K=4096 10 classes", big_b, big_s, None, big_c, g),
        ("equal scores", boxes[:1, :300], np.full((1, 300), .5, np.float32),
         None, cls[:1, :300], g),
        ("max_out above survivors", boxes[:, :200], scores[:, :200], None,
         cls[:, :200], dict(g, max_out=4000)),
        ("linear", boxes, scores, mask, cls, dict(g, method="linear")),
        ("hard", boxes, scores, mask, cls, dict(g, method="hard")),
        ("valid mask", boxes, scores, mask, cls, g),
        # long chains: weights near 1, few boxes dropped; the overlap skip
        # carries most slots of most steps
        ("sigma 2.0 (the skip, long chains)", boxes, scores, None, cls,
         dict(g, sigma=2.0)),
        # a zero overlap no longer gives weight 1: no skip, every open
        # slot takes the full arithmetic. Weights above 1 raise scores, so
        # a class's picks no longer fall in score and the serial kernel's
        # first max_out picks are not the top max_out by score: only the
        # plain version holds the kernel here
        ("sigma -0.5 (no skip)", boxes[:, :600], scores[:, :600], None,
         cls[:, :600], dict(g, sigma=-0.5)),
    ]
    return cases, (boxes, scores, None, cls)


def before_soft_nms_classes(torch, src):
    """The class-parallel soft-NMS built from another version of
    `soft_nms_classes.cu` in `src` (e.g. the parent commit's) into
    src/build, taking the arguments of `soft_nms_classes` and doing the
    same work around the launch (the C interface is the same), so that the
    two versions are timed on equal terms. It counts no launch."""
    import ctypes
    from pathlib import Path
    from rrnet_torch.ops.nms import _METHODS
    from rrnet_torch.utils import native
    src = Path(src)
    lib = native.build_all(("soft_nms_classes",), src, src / "build")
    fn = ctypes.CDLL(str(lib["soft_nms_classes"])).rrnet_soft_nms_classes
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])

    def run(boxes, scores, valid, cls, *, num_classes, sigma=0.5,
            iou_threshold=0.3, score_threshold=0.001, method="gaussian",
            max_out=None):
        bsz, k = scores.shape
        steps = k if max_out is None else min(max_out, k)
        dev = boxes.device
        out = (torch.empty((bsz, k), dtype=torch.float32, device=dev),
               torch.empty((bsz, k), dtype=torch.bool, device=dev),
               torch.empty((bsz, k), dtype=torch.int32, device=dev))
        err = fn(boxes.data_ptr(), scores.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 cls.data_ptr(), *(o.data_ptr() for o in out), bsz, k,
                 num_classes, steps, _METHODS[method], sigma, iou_threshold,
                 score_threshold, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{src}: soft_nms_classes launch failed: "
                               f"{err}")
        return out

    return run


def check_soft_nms_classes(torch, sn, rng, card, before=None):
    """Kernel B.2 against its plain version (bit for bit) and against the
    serial kernel B.1 (keep, rank and kept scores equal) on the card, at
    the stage-1 candidate shape and edge cases; timed beside its plain
    version and B.1 on the same inputs, with the busiest class's chain
    length per image. `before`, another build (`before_soft_nms_classes`),
    is timed on the same inputs in turns (before, after, after, before).
    Returns the kernel's line."""
    dev = torch.device("cuda")
    kw = dict(sigma=0.5, iou_threshold=0.7, score_threshold=0.1)
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    cases, main = classes_inputs(torch, rng)
    for name, b, s, v, c, settings in cases:
        args = (t(b), t(s), t(v), t(c))
        ckw = dict(kw, **settings)
        got = sn.soft_nms_classes(*args, num_classes=10, **ckw)
        torch.cuda.synchronize()
        ref = sn.soft_nms_classes_reference(*args, num_classes=10, **ckw)
        ser = sn.soft_nms(*args, **ckw)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"soft_nms_classes kernel differs from its "
                                 f"plain version ({name})")
        k = got[1]
        contract = ckw["method"] != "gaussian" or ckw["sigma"] > 0
        if contract and not (torch.equal(k, ser[1])
                             and torch.equal(got[2], ser[2])
                             and torch.equal(got[0][k], ser[0][k])):
            raise AssertionError(f"soft_nms_classes kernel breaks the "
                                 f"serial kernel's contract ({name})")
        print(f"  soft_nms_classes {name}: new_scores, keep, rank bit-equal "
              f"to the plain version; keep {int(k.sum())}"
              + (", kept ranks and scores equal to soft_nms" if contract
                 else " (weights above 1: no serial contract)"), flush=True)

    args = tuple(t(a) for a in main)
    ckw = dict(kw, max_out=512, method="gaussian")
    if before is not None:
        old = before(*args, num_classes=10, **ckw)
        new = sn.soft_nms_classes(*args, num_classes=10, **ckw)
        if not all(torch.equal(a, b) for a, b in zip(old, new)):
            raise AssertionError("soft_nms_classes: the --before build "
                                 "differs from this one")
    versions = {"after": lambda: sn.soft_nms_classes(*args, num_classes=10,
                                                     **ckw)}
    if before is not None:
        versions["before"] = lambda: before(*args, num_classes=10, **ckw)
    order = ["before", "after", "after", "before"] if before else ["after"]
    times = {v: [] for v in versions}
    for v in order:
        times[v].append(cuda_ms(versions[v], reps=50))
    ms = {v: float(np.mean(x)) for v, x in times.items()}
    split = {v: device_split(torch, f, reps=20)
             for v, f in versions.items()}
    device = {v: sum(d.values()) for v, d in split.items()}
    serial_ms = cuda_ms(lambda: sn.soft_nms(*args, **ckw), reps=50)
    plain_ms = cuda_ms(lambda: sn.soft_nms_classes_reference(
        *args, num_classes=10, **ckw), reps=3, warm=1)
    # the work these inputs need: each class's steps touch its open slots
    # and decay those that overlap its pick
    work = sn.soft_nms_classes_reference(*args, num_classes=10,
                                         return_work=True, **ckw)[3]
    # chain: each class runs to exhaustion, one selection a step
    sel = sn.soft_nms_classes_reference(*args, num_classes=10,
                                        **dict(ckw, max_out=None))[1]
    cls = args[3].long()
    chains = [int(torch.bincount(cls[i][sel[i]], minlength=10).max())
              for i in range(cls.shape[0])]
    bsz, kk = main[1].shape
    ops = (float(work[:, 0].sum()) * SOFT_NMS_OPS_PER_OPEN_SLOT
           + float(work[:, 1].sum()) * SOFT_NMS_OPS_PER_OVERLAP)
    nbytes = bsz * kk * ((16 + 4 + 4) + (4 + 1 + 4))
    bound_ops = ops / F32_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    parts = ", ".join(f"{k} {v:.4f}" for k, v in
                      sorted(split["after"].items()))
    print(f"  soft_nms_classes timing at B=4 K=1500 on {card}: kernel "
          f"{ms['after']:.4f} ms a call (device {device['after']:.4f} ms: "
          f"{parts}), serial kernel soft_nms on the same inputs "
          f"{serial_ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{max(bound_ops, bound_bytes):.6f} ms (open slot-steps per image "
          f"{work[:, 0].tolist()}, of them overlapping the pick "
          f"{work[:, 1].tolist()}, {ops:.0f} ops, {nbytes} bytes); busiest "
          f"class's chain per image {chains}: device "
          f"{device['after'] / max(chains) * 1e3:.3f} us a step of the "
          "longest; no PyTorch call computes soft-NMS, so library_ms is "
          "null", flush=True)
    if before is not None:
        print(f"  soft_nms_classes before/after at B=4 K=1500 on {card}: "
              f"{ms['before']:.4f} -> {ms['after']:.4f} ms a call "
              f"({ms['before'] / ms['after']:.2f}x); device "
              f"{device['before']:.4f} -> {device['after']:.4f} ms "
              f"({device['before'] / device['after']:.2f}x); chains "
              f"{chains}, longest {max(chains)}: "
              f"{device['before'] / max(chains) * 1e3:.3f} -> "
              f"{device['after'] / max(chains) * 1e3:.3f} us a step "
              f"(each the mean of two timings, before, after, after, before)",
              flush=True)
    line = {"name": "soft_nms_classes", "route": "cuda",
            "source": "rrnet_torch/csrc/soft_nms_classes.cu",
            "replaces": "rrnet_tpu/ops/pallas_nms.py:250",
            "launches": None, "max_abs_err": 0.0, "ms": ms["after"],
            "plain_ms": plain_ms, "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": None, "device_ms": device["after"],
            "chain_per_image": chains,
            "serial_kernel_ms_same_inputs": serial_ms}
    if before is not None:
        line.update(before_ms=ms["before"], before_device_ms=device["before"])
    return line


def check_hard_nms(torch, hn, rng, card):
    """Hard NMS against the plain fixpoint on the card (keep bit-equal) at
    the stage-1 candidate shape, per class and class-agnostic, and edge
    cases; timed beside the plain fixpoint and against its bound. Returns
    the kernel's line."""
    dev = torch.device("cuda")
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    boxes, scores, cls = detections_like(rng, 4, 1500, 10)
    mask = rng.rand(4, 1500) > 0.2
    big_b, big_s, big_c = detections_like(rng, 2, 4096, 10)
    n = 48          # each box 2 px right of the last: IoU 0.667, then 0.43
    x = 2.0 * np.arange(n, dtype=np.float32)
    chain = np.stack([x, np.zeros(n), x + 10, np.full(n, 10.0)],
                     -1)[None].astype(np.float32)
    ident = np.tile(np.array([[[10, 10, 20, 20]]], np.float32), (1, 64, 1))
    cases = [
        ("main B=4 K=1500 per-class", boxes, scores, None, cls, 0.7, False),
        ("main B=4 K=1500 class-agnostic", boxes, scores, None, None, 0.7,
         False),
        ("K=1", boxes[:, :1], scores[:, :1], None, cls[:, :1], 0.7, False),
        ("all invalid", boxes[:, :40], scores[:, :40],
         np.zeros((4, 40), bool), cls[:, :40], 0.7, False),
        ("identical boxes", ident, np.full((1, 64), .3, np.float32), None,
         None, 0.7, False),
        ("equal scores", boxes[:1, :300], np.full((1, 300), .5, np.float32),
         None, cls[:1, :300], 0.7, False),
        ("valid mask", boxes, scores, mask, cls, 0.7, False),
        ("plus_one", boxes, scores, mask, None, 0.5, True),
        ("a chain of 48, each suppressing the next", chain,
         np.linspace(1, .1, n, dtype=np.float32)[None], None, None, 0.5,
         False),
        ("K=4096", big_b, big_s, None, big_c, 0.5, False),
    ]
    for name, b, s, v, c, thr, plus_one in cases:
        args = (t(b), t(s), thr, t(v), t(c))
        got = hn.hard_nms(*args, plus_one=plus_one)
        torch.cuda.synchronize()
        ref = hn.hard_nms_reference(*args, plus_one=plus_one)
        if not torch.equal(got, ref):
            raise AssertionError(f"hard_nms kernel differs from the plain "
                                 f"fixpoint ({name}): "
                                 f"{int((got != ref).sum())} boxes")
        print(f"  hard_nms {name}: keep bit-equal to the plain fixpoint "
              f"({int(got.sum())} kept of {got.numel()})", flush=True)

    args = (t(boxes), t(scores), 0.7, None, t(cls))
    ms = cuda_ms(lambda: hn.hard_nms(*args), reps=50)
    split = device_split(torch, lambda: hn.hard_nms(*args), reps=20)
    kernels = sum(v for k, v in split.items() if "hard_nms_" in k)
    plain_ms = cuda_ms(lambda: hn.hard_nms_reference(*args), reps=3, warm=1)
    bsz, kk = scores.shape
    ops = bsz * kk * (kk - 1) / 2 * HARD_NMS_OPS_PER_PAIR
    nbytes = bsz * kk * ((16 + 4 + 4) + 1)
    bound_ops = ops / F32_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  hard_nms timing at B=4 K=1500 per class on {card}: wrapper "
          f"{ms:.4f} ms a call (device {sum(split.values()):.4f} ms: the "
          f"mask and scan kernels {kernels:.4f}, the score sort and the rest "
          f"{sum(split.values()) - kernels:.4f}), plain fixpoint "
          f"{plain_ms:.3f} ms, bound {max(bound_ops, bound_bytes):.6f} ms "
          f"({ops:.4g} ops over {bsz * kk * (kk - 1) // 2} pairs, {nbytes} "
          "bytes); no PyTorch call computes NMS (torchvision is not "
          "installed), so library_ms is null; " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(split.items())), flush=True)
    return {"name": "hard_nms", "route": "cuda",
            "source": "rrnet_torch/csrc/hard_nms.cu",
            "replaces": "rrnet_tpu/ops/nms.py:46 (not a TPU kernel: the "
                        "XLA hard-NMS fixpoint)",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": None, "device_ms": sum(split.values()),
            "kernels_device_ms": kernels}


def dcn_inputs(torch, rng, b, h, w, cin=256, cout=256, g=4, stride=1,
               dilation=1, offsets="fractional", masked=True,
               off_scale=1.5):
    """DCN inputs on the card, NCHW, made from `rng`: (x, weight, offset,
    mask, cotangent, kwargs)."""
    from rrnet_torch.ops.dcn import out_size
    pad = dilation
    ho, wo = out_size(h, w, 3, 3, stride, pad, dilation)
    shape = (b, 2 * g * 9, ho, wo)
    if offsets == "zero":
        off = np.zeros(shape, np.float32)
    elif offsets == "integer":
        off = rng.randint(-3, 4, shape).astype(np.float32)
    else:
        off = (rng.randn(*shape) * off_scale).astype(np.float32)
    arrays = [rng.randn(b, cin, h, w).astype(np.float32),
              (rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin))
              .astype(np.float32), off,
              rng.rand(b, g * 9, ho, wo).astype(np.float32) if masked
              else None,
              rng.randn(b, cout, ho, wo).astype(np.float32)]
    dev = torch.device("cuda")
    t = [None if a is None else torch.from_numpy(a).to(dev) for a in arrays]
    return t, dict(stride=stride, padding=pad, dilation=dilation,
                   deformable_groups=g)


def dcn_bounds(x, wt, off, mask, kw):
    """{"fwd", "bwd"} -> least time in ms from these inputs' shapes by two
    routes for the same f32-accurate work, each the larger of its times:
      "f32":    all operations on the CUDA cores (F32_FLOPS_PER_S), bytes
                over the HBM rate;
      "3xtf32": the GEMMs as three TF32 products on the tensor cores
                (TF32_FLOPS_PER_S), the side operations on the CUDA cores
                (the two pipes run at once, so the larger of these two
                times), bytes over the HBM rate;
    and "bound", the lower of the two, with what bounds it."""
    b, cin, h, w = x.shape
    cout = wt.shape[0]
    _, _, ho, wo = off.shape
    g = kw["deformable_groups"]
    samples = b * ho * wo * 9
    gemm = 2.0 * samples * cin * cout
    n_mask = 0 if mask is None else mask.numel()
    ins = 4 * (x.numel() + wt.numel() + off.numel() + n_mask)
    out = {}
    for name, gemms, per_ch, nbytes in (
            ("fwd", 1, DCN_FWD_OPS_PER_SAMPLE_CHANNEL,
             ins + 4 * b * cout * ho * wo),
            ("bwd", 2, DCN_BWD_OPS_PER_SAMPLE_CHANNEL,
             2 * ins + 4 * b * cout * ho * wo)):
        side = samples * cin * per_ch + samples * g * DCN_OPS_PER_SAMPLE
        ops = gemms * gemm + side
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        routes = {
            "f32": {"operations": ops / F32_FLOPS_PER_S * 1e3,
                    "bytes": t_bytes},
            "3xtf32": {"operations": max(3 * gemms * gemm / TF32_FLOPS_PER_S,
                                         side / F32_FLOPS_PER_S) * 1e3,
                       "bytes": t_bytes}}
        r = {k: (max(v.values()), max(v, key=v.get)) for k, v in
             routes.items()}
        best = min(r, key=lambda k: r[k][0])
        out[name] = dict(r, bound=(r[best][0], r[best][1], best), ops=ops,
                         nbytes=nbytes)
    return out


def before_dcn(torch, src):
    """(forward, backward) of the DCN kernels built from the sources in
    `src` (another version of rrnet_torch/csrc's dcn_fwd.cu, dcn_bwd.cu
    and dcn_common.cuh, e.g. the parent commit's) into src/build, taking
    the arguments of `deform_conv2d` (no autograd) and of
    `deform_conv2d_backward` and doing the same layout work around the
    launch, so that the two versions are timed on equal terms. They count
    no launch."""
    import ctypes
    from pathlib import Path
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.utils import native
    src = Path(src)
    libs = native.build_all(("dcn_fwd", "dcn_bwd"), src, src / "build")
    geom_types = [ctypes.c_int] * 13
    fwd_c = ctypes.CDLL(str(libs["dcn_fwd"])).rrnet_dcn_fwd
    fwd_c.argtypes = [ctypes.c_void_p] * 6 + geom_types + [ctypes.c_void_p]
    bwd_c = ctypes.CDLL(str(libs["dcn_bwd"])).rrnet_dcn_bwd
    bwd_c.argtypes = [ctypes.c_void_p] * 9 + geom_types + [ctypes.c_void_p]

    def launch(fn, tensors, geom):
        ptrs = [None if t is None else t.data_ptr() for t in tensors]
        err = fn(*ptrs, *geom, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{src}: DCN kernel launch failed: {err}")

    def geometry(x, wt, off, mask, bias, kw):
        return tdc._geometry(x, wt, off, mask, bias, kw["stride"],
                             kw["padding"], kw["dilation"],
                             kw["deformable_groups"])

    def forward(x, wt, off, mask, bias, **kw):
        geom = geometry(x, wt, off, mask, bias, kw)
        b, _, _, _, cout, _, _, ho, wo = geom[:9]
        out = x.new_empty((b, cout, ho, wo))
        launch(fwd_c, (x.permute(0, 2, 3, 1).contiguous(),
                       wt.permute(2, 3, 1, 0).contiguous(), off, mask, bias,
                       out), geom)
        return out

    def backward(x, wt, off, mask, ct, **kw):
        geom = geometry(x, wt, off, mask, None, kw)
        b, h, w, cin, cout, kh, kw_ = geom[:7]
        gx = x.new_empty((b, h, w, cin))
        gw = x.new_empty((kh, kw_, cin, cout))
        goff = torch.empty_like(off)
        gmask = None if mask is None else torch.empty_like(mask)
        launch(bwd_c, (x.permute(0, 2, 3, 1).contiguous(),
                       wt.permute(2, 3, 0, 1).contiguous(), off, mask, ct, gx,
                       gw, goff, gmask), geom)
        return (gx.permute(0, 3, 1, 2).contiguous(),
                gw.permute(3, 2, 0, 1).contiguous(), goff, gmask)

    return forward, backward


def device_split(torch, fn, reps=5):
    """{kernel name: device ms per call of `fn`}, by torch.profiler over
    `reps` calls after one warm-up."""
    from rrnet_torch.profile_trident import kernel_name
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = kernel_name(e.key)
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / reps)
    return out


def profile_split(torch, fn, reps=5):
    """{kernel name: ms per call} of `fn`'s DCN kernels (each launches
    once a call)."""
    return {k: v for k, v in device_split(torch, fn, reps).items()
            if "dcn_" in k}


def check_dcn(torch, rng, card, before=None):
    """Kernels B.3 / B.4 against the plain DCN and its autograd on the
    card, at the trident path's shapes (serve 1x256x48x88, train
    4x256x32x32, dilations 1-3) and edge cases; each path shape timed
    beside both bound routes, the plain version and F.conv2d (cuDNN, TF32
    off) at the same shape and dilation, the backward's data and weight
    kernels apart. `before`, another build of the kernels
    (`before_dcn`), is timed on the same inputs in turns
    (before, after, after, before) and printed beside them, one line a
    shape. Returns the two kernels' lines."""
    import torch.nn.functional as F
    from rrnet_torch.models.layers import cudnn_f32
    from rrnet_torch.ops import dcn
    from rrnet_torch.ops import deform_conv as tdc

    def err(got, ref):
        return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1e-30)

    serve, train = dict(b=1, h=48, w=88), dict(b=4, h=32, w=32)
    cases = [(f"serve d{d}", dict(serve, dilation=d)) for d in (1, 2, 3)]
    cases += [(f"train d{d}", dict(train, dilation=d)) for d in (1, 2, 3)]
    cases += [
        ("zero offsets", dict(train, offsets="zero")),
        ("integer offsets", dict(train, offsets="integer", dilation=3)),
        ("outside the image", dict(b=2, h=12, w=20, cin=64, cout=64,
                                   off_scale=8.0)),
        ("g1 stride 2", dict(b=2, h=15, w=17, cin=24, cout=40, g=1,
                             stride=2)),
        ("no mask, odd channels", dict(b=3, h=9, w=11, cin=40, cout=70, g=2,
                                       masked=False)),
        ("cpg 6 (scalar paths), Cout 20", dict(b=2, h=7, w=13, cin=18,
                                               cout=20, g=3)),
        # grad weight summed over 32768 positions: the weight kernel's
        # blocks each take a run of ~140 units
        ("long runs, B 32", dict(b=32, h=32, w=32)),
    ]
    # f32 sums of up to 2304 (forward) and 4224 x 4 (grad weight) products
    # in another order; the backward's atomics add in a run-dependent order
    tol_fwd, tol_bwd = 2e-5, 5e-5
    rows = {}
    for name, spec in cases:
        (x, wt, off, mask, ct), kw = dcn_inputs(torch, rng, **spec)
        with torch.no_grad():
            got = tdc.deform_conv2d(x, wt, off, mask, None, **kw)
            torch.cuda.synchronize()
            ref = dcn.deform_conv2d(x, wt, off, mask, None, **kw)
        e_fwd = err(got, ref)
        gots = tdc.deform_conv2d_backward(x, wt, off, mask, ct, **kw)
        torch.cuda.synchronize()
        refs = tdc.deform_conv2d_backward_reference(x, wt, off, mask, ct,
                                                    **kw)
        e_bwd = [0.0 if r is None else err(g_, r) for g_, r in
                 zip(gots, refs)]
        abs_fwd = float((got - ref).abs().max())
        abs_bwd = max(float((g_ - r).abs().max()) for g_, r in
                      zip(gots, refs) if r is not None)
        if e_fwd > tol_fwd or max(e_bwd) > tol_bwd:
            raise AssertionError(
                f"dcn kernels differ from the plain version ({name}): "
                f"fwd {e_fwd:.3g} (tol {tol_fwd}), bwd x/w/offset/mask "
                f"{[f'{e:.3g}' for e in e_bwd]} (tol {tol_bwd})")
        print(f"  dcn {name} x{tuple(x.shape)}: max |err| / max |ref| fwd "
              f"{e_fwd:.3g}; bwd x {e_bwd[0]:.3g} weight {e_bwd[1]:.3g} "
              f"offset {e_bwd[2]:.3g} mask {e_bwd[3]:.3g}", flush=True)
        if not name.startswith(("serve", "train")):
            continue
        # timing at the path's shapes
        def fwd(k=tdc.deform_conv2d):
            with torch.no_grad():
                return k(x, wt, off, mask, None, **kw)

        def bwd(k=tdc.deform_conv2d_backward):
            return k(x, wt, off, mask, ct, **kw)

        with torch.no_grad():
            plain_fwd = cuda_ms(lambda: dcn.deform_conv2d(
                x, wt, off, mask, None, **kw), reps=5)
            with cudnn_f32():
                conv_fwd = cuda_ms(lambda: F.conv2d(
                    x, wt, None, 1, kw["padding"], kw["dilation"]), reps=20)
        leaves = [a.detach().requires_grad_() for a in (x, wt, off, mask)]
        with torch.enable_grad():
            graph = dcn.deform_conv2d(*leaves, None, **kw)
        plain_bwd = cuda_ms(lambda: torch.autograd.grad(
            graph, leaves, ct, retain_graph=True), reps=5)
        del graph
        with cudnn_f32():
            conv_bwd = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                ct, x, wt, None, [1, 1], [kw["padding"]] * 2,
                [kw["dilation"]] * 2, False, [0, 0], 1, [True, True, False]),
                reps=20)
        versions = {"after": (fwd, bwd)}
        if before is not None:
            versions["before"] = (lambda: fwd(before[0]),
                                  lambda: bwd(before[1]))
        order = (["before", "after", "after", "before"] if before else
                 ["after"])
        times = {v: {"fwd": [], "bwd": []} for v in versions}
        for v in order:
            times[v]["fwd"].append(cuda_ms(versions[v][0], reps=20))
            times[v]["bwd"].append(cuda_ms(versions[v][1], reps=20))
        ms = {v: {k: float(np.mean(t)) for k, t in d.items()}
              for v, d in times.items()}
        split = {v: profile_split(torch, versions[v][1]) for v in versions}
        bounds = dcn_bounds(x, wt, off, mask, kw)
        rows[name] = dict(ms=ms, split=split, bounds=bounds,
                          fwd=(ms["after"]["fwd"], plain_fwd, conv_fwd,
                               abs_fwd),
                          bwd=(ms["after"]["bwd"], plain_bwd, conv_bwd,
                               abs_bwd))
        for k in ("fwd", "bwd"):
            t, pm, cm, _ = rows[name][k]
            bd = bounds[k]
            print(f"  dcn_{k} {name} on {card}: kernel {t:.4f} ms, plain "
                  f"{pm:.3f} ms, F.conv2d{' backward' if k == 'bwd' else ''}"
                  f" {cm:.4f} ms, bound {bd['bound'][0]:.6f} ms "
                  f"({bd['bound'][2]} route, {bd['bound'][1]}); f32 route "
                  f"{bd['f32'][0]:.6f} ms ({bd['f32'][1]}), 3xTF32 route "
                  f"{bd['3xtf32'][0]:.6f} ms ({bd['3xtf32'][1]}); "
                  f"{bd['ops']:.4g} ops, {bd['nbytes']} bytes", flush=True)
        sp = split["after"]
        print(f"  dcn_bwd {name} kernels (torch.profiler): "
              + ", ".join(f"{n} {v:.4f} ms" for n, v in sorted(sp.items())),
              flush=True)
        if before is not None:
            b_, a_ = ms["before"], ms["after"]
            sb = split["before"]
            print(f"  dcn before/after {name} on {card}: fwd "
                  f"{b_['fwd']:.4f} -> {a_['fwd']:.4f} ms "
                  f"({b_['fwd'] / a_['fwd']:.2f}x); bwd {b_['bwd']:.4f} -> "
                  f"{a_['bwd']:.4f} ms ({b_['bwd'] / a_['bwd']:.2f}x; data "
                  f"{sb.get('dcn_bwd_data_kernel', 0):.4f} -> "
                  f"{sp.get('dcn_bwd_data_kernel', 0):.4f}, weight "
                  f"{sb.get('dcn_bwd_weight_kernel', 0):.4f} -> "
                  f"{sp.get('dcn_bwd_weight_kernel', 0):.4f}); bounds fwd "
                  f"f32 {bounds['fwd']['f32'][0]:.6f} / 3xTF32 "
                  f"{bounds['fwd']['3xtf32'][0]:.6f}, bwd f32 "
                  f"{bounds['bwd']['f32'][0]:.6f} / 3xTF32 "
                  f"{bounds['bwd']['3xtf32'][0]:.6f} ms", flush=True)

    def line(k, source, replaces, shape):
        t, pm, cm, e = rows[shape][k]
        bd = rows[shape]["bounds"][k]
        entry = {"name": f"dcn_{k}", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": None, "max_abs_err": e,
                 "ms": t, "plain_ms": pm, "bound_ms": bd["bound"][0],
                 "bound_by": bd["bound"][1], "bound_route": bd["bound"][2],
                 "bound_ms_f32": bd["f32"][0],
                 "bound_ms_3xtf32": bd["3xtf32"][0],
                 "library_ms": None, "shape": shape,
                 "yardstick_conv2d_ms": cm,
                 "by_shape": {n: {"ms": r[k][0], "plain_ms": r[k][1],
                                  "bound_ms": r["bounds"][k]["bound"][0],
                                  "yardstick_conv2d_ms": r[k][2],
                                  **({"before_ms": r["ms"]["before"][k]}
                                     if "before" in r["ms"] else {}),
                                  **({"kernels_ms": r["split"]["after"]}
                                     if k == "bwd" else {})}
                              for n, r in rows.items()}}
        if "before" in rows[shape]["ms"]:
            entry["before_ms"] = rows[shape]["ms"]["before"][k]
        return entry
    return (line("fwd", "rrnet_torch/csrc/dcn_fwd.cu",
                 "rrnet_tpu/ops/pallas_dcn.py:109", "serve d2"),
            line("bwd", "rrnet_torch/csrc/dcn_bwd.cu",
                 "rrnet_tpu/ops/pallas_dcn.py:376", "train d2"))


def check_small_reference(torch):
    """Tiny RRNet, f32, with stage-1 hard NMS (the default) and with
    soft-NMS: the card against the CPU on the same weights."""
    from rrnet_torch import config
    from rrnet_torch.models import build_model
    for nms_type in ("nms", "soft_nms"):
        cfg = config.rrnet_config(**{
            "model.backbone": "tiny_hourglass", "model.topk": 256,
            "model.stage2_rois": 64, "model.dtype": "float32",
            "model.nms_type_for_stage1": nms_type})
        cpu = build_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad():         # spread the logits: no near-ties
            for i in range(2):
                getattr(cpu.hm, f"out{i}").weight.mul_(40.0)
        gpu = build_model(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 128, 160)
                             .astype(np.float32))
        vhw = torch.tensor([[128, 160], [100, 120]], dtype=torch.int32)
        with torch.inference_mode():
            a = cpu(x, valid_hw=vhw)
            b = gpu(x.cuda(), valid_hw=vhw.cuda())
        for name in ("roi_valid", "roi_classes"):
            if not torch.equal(getattr(a, name), getattr(b, name).cpu()):
                raise AssertionError(f"tiny f32 RRNet ({nms_type}): {name} "
                                     "differ cuda vs cpu")
        torch.testing.assert_close(b.rois.cpu(), a.rois, atol=1e-3, rtol=0)
        torch.testing.assert_close(b.hms[-1].cpu(), a.hms[-1], atol=1e-4,
                                   rtol=1e-4)
        torch.testing.assert_close(b.stage2_reg.cpu(), a.stage2_reg,
                                   atol=1e-4, rtol=1e-4)
        print(f"  tiny RRNet f32 ({nms_type}) cuda == cpu: "
              f"{int(a.roi_valid.sum())} ROIs, classes/validity equal, boxes "
              "within 1e-3, heads within 1e-4", flush=True)


def check_small_train(torch):
    """One tiny RRNet train step (tiny_hourglass, f32, batch 2x3x64x64)
    on the card against the same step on the CPU from the same state.
    Stage-1 soft-NMS: losses within 1e-4, the same ROI selection, every
    gradient within 1e-3 of its largest magnitude (the backward's
    scatter-adds run by atomics in another order). Stage-1 hard NMS (the
    preset's): the same candidates kept, the same ROIs in the same order
    and the same stage-2 positives, and every gradient within 1e-3 once
    the card's stage 2 takes the CPU's ROIs bit for bit
    (`explain_small_train_gap`). With the card's own ROIs this seed's
    hard-NMS gradients land up to 0.9% apart, and that is conditioning,
    not a fault: the ROI coordinates come out of the f32 convolutions
    ~3e-6 apart, and one pre-ReLU value of the stage-2 bottleneck (bn1 of
    ROI 9 of image 1) lies 5.8e-6 above 0, so a shift of that ROI by a
    relative 1e-6 flips the ReLU, on the CPU alone too, and moves the
    head's conv1 gradient by 0.9%. So soft-NMS, whose ROIs keep off that
    kink, is the one held with the card's own ROIs."""
    cpu, gpu, state, batch = small_train_setup(torch, "soft_nms")
    outs = {}
    for name, tr in (("cpu", cpu), ("cuda", gpu)):
        tr.model.register_forward_hook(
            lambda m, a, o, name=name: outs.setdefault(name, o))
    gstate = state.to("cuda")
    tot_c, g_c = cpu.loss_and_grads(state, batch)
    tot_g, g_g = gpu.loss_and_grads(gstate, batch)
    a, b = outs["cpu"], outs["cuda"]
    for name in ("roi_valid", "roi_classes"):
        if not torch.equal(getattr(a, name), getattr(b, name).cpu()):
            raise AssertionError(f"tiny train step: {name} differ cuda vs "
                                 "cpu")
    torch.testing.assert_close(b.rois.detach().cpu(), a.rois.detach(),
                               atol=1e-3, rtol=0)
    errs = grad_gaps(g_c, g_g)
    if not errs[0][0] <= 1e-3:
        raise AssertionError(f"tiny train step gradients cuda vs cpu: "
                             f"{errs[:3]} > 1e-3")
    _, m_c = cpu.train_step(state, batch)
    _, m_g = gpu.train_step(gstate, batch)
    worst = max(abs(float(m_g[k]) - float(m_c[k]))
                / max(abs(float(m_c[k])), 1e-30) for k in m_c)
    if not worst <= 1e-4 or float(m_c["s2"]) <= 0:
        raise AssertionError(f"tiny train step losses cuda vs cpu: {m_c} / "
                             f"{m_g}")
    print(f"  tiny RRNet train step f32 (soft-NMS) cuda == cpu: "
          f"{int(a.roi_valid.sum())} ROIs equal; losses within {worst:.3g} "
          f"(s2 {float(m_c['s2']):.4f}); {len(errs)} gradients within "
          f"{errs[0][0]:.3g} of their largest magnitude (worst "
          f"{errs[0][1]})", flush=True)
    explain_small_train_gap(torch)


def small_train_setup(torch, nms_type):
    """(cpu trainer, cuda trainer, state, batch) of the tiny f32 train
    step with stage-1 `nms_type`: half of the GT boxes are the CPU step's
    own ROIs, so stage 2 has positives."""
    from rrnet_torch import config
    from rrnet_torch.profile_train import synthetic_batch
    from rrnet_torch.train import Trainer
    cfg = config.rrnet_config(**{
        "model.backbone": "tiny_hourglass", "model.topk": 64,
        "model.stage2_rois": 16, "model.dtype": "float32",
        "model.nms_type_for_stage1": nms_type, "train.crop_size": (64, 64),
        "train.max_objects": 16, "train.stage2_warmup_steps": 0})
    cpu, gpu = Trainer(cfg, device="cpu"), Trainer(cfg, device="cuda")
    state = cpu.init_state(generator=torch.Generator().manual_seed(1))
    params = state.params()
    with torch.no_grad():         # spread the logits: no near-ties
        for i in range(2):
            params[f"hm.out{i}.weight"].mul_(40.0)
    batch = synthetic_batch(np.random.RandomState(4), b=2, hw=(64, 64),
                            max_objects=16, n_valid=(10, 16),
                            size=(2.0, 24.0))
    outs = []
    h = cpu.model.register_forward_hook(lambda m, a, o: outs.append(o))
    cpu.loss_and_grads(state, batch)
    h.remove()
    rois = outs[0].rois.detach().numpy() * 4.0
    n = min(8, rois.shape[1])
    batch["annos"][:, :n, :2] = rois[:, :n, :2]
    batch["annos"][:, :n, 2:4] = rois[:, :n, 2:] - rois[:, :n, :2]
    batch["annos"][:, :n, 5] = 1.0
    batch["valid"][:, :n] = outs[0].roi_valid[:, :n].numpy()
    return cpu, gpu, state, batch


def grad_gaps(g_ref, g):
    """[(max |g - ref| / max |ref|, name)] over the parameters, worst
    first."""
    return sorted(((float((g[k].cpu() - r.cpu()).abs().max())
                    / max(float(r.abs().max()), 1e-30), k)
                   for k, r in g_ref.items()), reverse=True)


def explain_small_train_gap(torch):
    """The tiny train step with stage-1 hard NMS, card against CPU: are
    the ROI selection and the stage-2 targets bitwise equal, where do the
    gradients part, and do they meet again when the card's stage 2 gets
    the CPU's ROIs bit for bit (through `rois + (rois_cpu - rois)
    .detach()`, so that gradients still reach the boxes)? Prints the
    numbers and raises unless the selection, the ROI order and the
    stage-2 positives are equal and the gradients with the CPU's ROIs lie
    within 1e-3 of their largest magnitude."""
    from rrnet_torch.ops import box as boxops
    from rrnet_torch.ops import hard_nms as hn
    from rrnet_torch.ops.heatmap import topk_desc
    cpu, gpu, state, batch = small_train_setup(torch, "nms")
    gstate = state.to("cuda")
    seen = {}

    def record(name, tr, feed=None):
        orig = type(tr.model).select_rois.__get__(tr.model)

        def select(boxes, scores, classes):
            out = orig(boxes, scores, classes)
            if feed is not None:
                rois = out[0] + (feed.to(out[0].device) - out[0]).detach()
                out = (rois,) + tuple(out[1:])
            keep = hn.hard_nms(boxes.detach(), scores.detach(),
                               tr.model.nms_iou, class_ids=classes)
            order = topk_desc(torch.where(keep, scores.detach(), -torch.inf),
                              tr.model.stage2_rois)[1]
            seen[name] = dict(boxes=boxes.detach().cpu(),
                              scores=scores.detach().cpu(),
                              classes=classes.cpu(), keep=keep.cpu(),
                              order=order.cpu(),
                              out=[o.detach().cpu() for o in out])
            return out
        tr.model.select_rois = select

    def targets(out):
        annos = torch.from_numpy(batch["annos"]).float()
        valid = torch.from_numpy(batch["valid"])
        rois_in = out[0] * 4
        gt = boxops.xywh_to_xyxy(annos[..., :4])
        iou = torch.where(valid[:, None, :],
                          boxops.pairwise_iou(rois_in, gt), 0.0)
        max_iou, max_idx = iou.max(dim=-1)
        pos = (max_iou > 0.5) & out[3]
        matched = torch.gather(gt, 1, max_idx[..., None].expand(-1, -1, 4))
        return pos, boxops.encode_boxes(rois_in, matched)

    def bits_equal(a, b):
        if a.is_floating_point():
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)

    record("cpu", cpu)
    record("cuda", gpu)
    _, g_c = cpu.loss_and_grads(state, batch)
    _, g_g = gpu.loss_and_grads(gstate, batch)
    c, g = seen["cpu"], seen["cuda"]
    names = ("rois", "roi_scores", "roi_classes", "roi_valid")
    diff = {k: float((c[k] - g[k]).abs().max()) for k in ("boxes", "scores")}
    print("  tiny train step with hard NMS, card vs CPU: " + ", ".join(
        f"{n} bitwise {bits_equal(a, b)}"
        for n, a, b in zip(names, c["out"], g["out"]))
        + f"; max |rois diff| "
        f"{float((c['out'][0] - g['out'][0]).abs().max()):.3g}; candidates' "
        f"max |diff| boxes {diff['boxes']:.3g}, scores {diff['scores']:.3g}, "
        f"classes equal {torch.equal(c['classes'], g['classes'])}",
        flush=True)
    kernel_keep = hn.hard_nms(c["boxes"].cuda(), c["scores"].cuda(),
                              gpu.model.nms_iou,
                              class_ids=c["classes"].cuda()).cpu()
    print(f"  hard_nms keep equal {torch.equal(c['keep'], g['keep'])} "
          f"({int(c['keep'].sum())} / {int(g['keep'].sum())} kept); on the "
          f"CPU's candidates the kernel's keep equals the plain one "
          f"{torch.equal(kernel_keep, c['keep'])}; ROI order equal "
          f"{torch.equal(c['order'], g['order'])}: {c['order'].tolist()}",
          flush=True)
    pc, tc = targets(c["out"])
    pg, tg = targets(g["out"])
    print(f"  stage-2 targets: positives equal {torch.equal(pc, pg)} "
          f"({int(pc.sum())}), deltas bitwise {bits_equal(tc, tg)}, max "
          f"|diff| {float((tc - tg).abs().max()):.3g}", flush=True)
    own = grad_gaps(g_c, g_g)
    print("  gradients, card's own ROIs: " + "; ".join(
        f"{k} {e:.3g}" for e, k in own[:6]), flush=True)

    record("cuda", gpu, feed=c["out"][0])
    _, g_f = gpu.loss_and_grads(gstate, batch)
    f = seen["cuda"]
    fed = grad_gaps(g_c, g_f)
    print(f"  the CPU's ROIs fed to the card's stage 2: rois bitwise "
          f"{bits_equal(f['out'][0], c['out'][0])}; gradients: " + "; ".join(
              f"{k} {e:.3g}" for e, k in fed[:6]), flush=True)
    # the same sensitivity on the CPU alone: its own ROIs scaled by
    # (1 + 1e-6), and the stage-2 bottleneck's pre-ReLU values (bn1, bn2)
    # that change sign
    pre = {}
    hooks = [getattr(cpu.model.head_detector.top, n).register_forward_hook(
        lambda m, a, o, n=n: pre.setdefault(n, []).append(o.detach()))
        for n in ("bn1", "bn2")]
    record("cpu", cpu)
    cpu.loss_and_grads(state, batch)
    record("cpu", cpu, feed=c["out"][0] * (1.0 + 1e-6))
    _, g_s = cpu.loss_and_grads(state, batch)
    for h in hooks:
        h.remove()
    flips = [(n, v[-2][(v[-2] > 0) != (v[-1] > 0)]) for n, v in pre.items()]
    shifted = grad_gaps(g_c, g_s)
    print(f"  on the CPU alone, its ROIs scaled by (1 + 1e-6): gradients "
          f"{shifted[0][1]} {shifted[0][0]:.3g}; stage-2 pre-ReLU values "
          "that change sign: " + ", ".join(
              f"{n} {[float(x) for x in v]}" for n, v in flips), flush=True)
    same = (all(torch.equal(a, b) for a, b in zip(c["out"][1:],
                                                  g["out"][1:]))
            and torch.equal(c["keep"], g["keep"])
            and torch.equal(kernel_keep, c["keep"])
            and torch.equal(c["order"], g["order"]) and torch.equal(pc, pg)
            and bits_equal(f["out"][0], c["out"][0]))
    if not same or not fed[0][0] <= 1e-3:
        raise AssertionError(f"tiny train step with hard NMS, cuda vs cpu: "
                             f"selection, order and positives equal {same}; "
                             f"gradients with the CPU's ROIs {fed[:3]} "
                             "(tol 1e-3)")


def check_small_trident(torch):
    """trires50deform at 2x3x64x64, f32: the card (DCN kernels) against
    the CPU (the plain DCN, which the CPU tests hold to the JAX package)
    on the same weights, eval maps and train-mode maps."""
    from rrnet_torch.profile_trident import path_model
    cpu = path_model(device="cpu")
    gpu = path_model(device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 3, 64, 64)
                         .astype(np.float32))
    errs = []
    with torch.no_grad():
        for train, tol in ((False, 1e-4), (True, 5e-4)):
            a = cpu.train(train)(x)
            b = gpu.train(train)(x.cuda())
            for i, (ta, tb) in enumerate(zip(a, b)):
                e = float((tb.cpu() - ta).abs().max() / ta.abs().max())
                if not e <= tol:
                    raise AssertionError(f"small trident l{i + 1} "
                                         f"({'train' if train else 'eval'})"
                                         f": cuda vs cpu {e:.3g} > {tol}")
                errs.append(e)
    print(f"  trires50deform 2x3x64x64 f32 cuda == cpu: eval and train maps "
          f"l1..l4 within {max(errs):.3g} of the largest magnitude",
          flush=True)


def check_detections(dets, max_rows, n_cls):
    if dets.ndim != 2 or dets.shape[1] != 6 or not 0 < len(dets) <= max_rows:
        raise AssertionError(f"bad detections shape {dets.shape}")
    if not np.isfinite(dets).all():
        raise AssertionError("non-finite detections")
    c = dets[:, 5]
    if not (np.all(c == np.round(c)) and c.min() >= 1 and c.max() <= n_cls):
        raise AssertionError("classes outside 1..num_classes")
    if not (np.all(np.diff(dets[:, 4]) <= 0) and dets[:, 4].min() >= 0):
        raise AssertionError("scores not non-increasing and non-negative")


def run_main_path(torch, sn, hn, card, before_soft=None):
    """Phase 5: the flagship preset served through `Predictor` at its
    defaults (hard NMS), then on the same model and weights with per-class
    soft-NMS and with class-agnostic soft-NMS. Each setting runs with every
    launch count set to 0 just before it and read just after; one
    request's ROI selection is redone with the plain version of the NMS it
    took, and `select_rois` runs once more under the CUDA sync debug mode
    "error". B.1 is then timed on that request's own candidates in the
    class-agnostic setting (`time_soft_nms`; `before_soft`, the parent's
    build, beside it). Returns ({setting: launch counts}, that timing)."""
    from rrnet_torch import config
    from rrnet_torch.models import build_model
    from rrnet_torch.models.rrnet import mask_heatmap_extent
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.ops.heatmap import topk_decode, topk_desc
    from rrnet_torch.serving import Predictor

    cfg = config.rrnet_config()
    if cfg.model.nms_type_for_stage1 != "nms":
        raise AssertionError("the preset's stage-1 NMS is no longer hard NMS")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    print(f"  model: {sum(p.numel() for p in model.parameters())} params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    pred = Predictor(cfg, model, device="cuda")

    forwards = []
    model.register_forward_hook(
        lambda module, args, kwargs, out: forwards.append(
            (out, kwargs.get("valid_hw"))), with_kwargs=True)
    rng = np.random.RandomState(cfg.seed)
    sizes = [(765, 1360), (700, 1300), (768, 1408), (641, 1281),
             (720, 1350), (750, 1400), (690, 1290), (760, 1380)]
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in sizes]

    def serve(n_images, passes, batch, warmup):
        forwards.clear()
        hn.launches = sn.launches = sn.classes_launches = 0    # every count
        tdc.fwd_launches = tdc.bwd_launches = 0                # to 0
        if warmup:
            pred.warmup(((765, 1360),), batch_sizes=(1, 4))
        n_warm = len(forwards)
        # single requests, `passes` times over the same sizes: the first
        # pass meets each size for the first time; the batch on its own
        # clock
        times = [[] for _ in range(passes)]
        outs = []
        for ms_list in times:
            for im in images[:n_images]:
                t0 = time.perf_counter()
                outs.append(pred.predict(im))
                ms_list.append((time.perf_counter() - t0) * 1e3)
        batch_ms = None
        if batch:
            t0 = time.perf_counter()
            outs += pred.predict_batch(images[:4])
            batch_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        counts = {"hard_nms": hn.launches, "soft_nms": sn.launches,
                  "soft_nms_classes": sn.classes_launches,
                  "dcn": tdc.fwd_launches + tdc.bwd_launches}  # just after
        for d in outs:
            check_detections(d, cfg.model.stage2_rois, cfg.num_classes)
        return times, batch_ms, counts, n_warm

    def redo(select, name):
        """Request sizes[3]'s ROI selection again from its own heads, with
        `select(dets) -> masked scores`: the same ROIs, classes and
        validity, and scores within rtol 1e-5 (the plain serial soft-NMS
        may divide by sigma as a multiply by its reciprocal; hard NMS
        passes the scores through, equal); then `select_rois` on the same
        candidates under the sync debug mode "error"."""
        out, vhw = forwards[n_warm + 3]
        with torch.inference_mode():
            hm = mask_heatmap_extent(out.hms[-1].float(), vhw, 4)
            dets = topk_decode(hm, out.whs[-1].float(),
                               out.offsets[-1].float(), k=model.topk)
            top, idx = topk_desc(select(dets), model.stage2_rois)
            valid = top > -torch.inf
            rois = torch.gather(dets.boxes, 1,
                                idx[..., None].expand(-1, -1, 4))
            if not (torch.equal(valid, out.roi_valid)
                    and torch.equal(rois, out.rois)
                    and torch.equal(torch.gather(dets.classes, 1, idx),
                                    out.roi_classes)):
                raise AssertionError(f"main-path ROI selection differs from "
                                     f"the plain {name}")
            torch.testing.assert_close(torch.where(valid, top, 0.0),
                                       out.roi_scores, rtol=1e-5, atol=0)
            args = (dets.boxes.contiguous(), dets.scores.contiguous(),
                    dets.classes.contiguous())
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = model.select_rois(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if not torch.equal(again[0], out.rois):
                raise AssertionError("select_rois under the sync debug mode "
                                     "differs")
        return int(out.roi_valid.sum()), args

    def report(setting, times, batch_ms, counts, n_rois, name):
        flat = [x for p in times for x in p]
        p50, p90 = np.percentile(flat, [50, 90])
        print(f"  {setting}: {len(forwards)} forwards ({n_warm} warm-up), "
              f"launches {counts}; request {sizes[3]} ROI selection == the "
              f"plain {name} ({n_rois} ROIs); select_rois ran under the "
              "sync debug mode \"error\"", flush=True)
        print(f"  {setting} single-request latency on {card}: p50 "
              f"{p50:.2f} ms, p90 {p90:.2f} ms over {len(flat)} requests"
              + "".join(f"; pass {i + 1} p50 {np.percentile(p, 50):.2f} p90 "
                        f"{np.percentile(p, 90):.2f}"
                        for i, p in enumerate(times))
              + f"; per request {[round(x, 2) for x in flat]}"
              + (f"; predict_batch of 4 {batch_ms:.2f} ms" if batch_ms
                 else ""), flush=True)

    m = model
    results = {}
    # 1. the preset's defaults: per-class hard NMS
    times, batch_ms, counts, n_warm = serve(len(images), 2, True, True)
    want = {"hard_nms": len(forwards), "soft_nms": 0, "soft_nms_classes": 0,
            "dcn": 0}
    if counts != want or len(forwards) != 2 + 2 * len(images) + 1:
        raise AssertionError(f"defaults: launches {counts} in "
                             f"{len(forwards)} forwards (want {want})")
    n_rois, _ = redo(lambda d: torch.where(hn.hard_nms_reference(
        d.boxes, d.scores, m.nms_iou, None, d.classes), d.scores,
        -torch.inf), "hard-NMS fixpoint")
    report("defaults (hard NMS)", times, batch_ms, counts, n_rois,
           "hard-NMS fixpoint")
    results["defaults"] = counts

    def plain_soft(per_class):
        def select(d):
            ns, keep, _ = sn.soft_nms_reference(
                d.boxes, d.scores, None, d.classes if per_class else None,
                sigma=m.soft_nms_sigma, iou_threshold=m.nms_iou,
                score_threshold=m.soft_nms_score_threshold,
                method="gaussian", max_out=m.stage2_rois)
            return torch.where(keep, ns, -torch.inf)
        return select

    # 2. per-class soft-NMS: the class-parallel kernel, never the serial one
    m.nms_type = "soft_nms"
    times, batch_ms, counts, n_warm = serve(len(images), 2, True, False)
    want = {"hard_nms": 0, "soft_nms": 0,
            "soft_nms_classes": len(forwards), "dcn": 0}
    if counts != want:
        raise AssertionError(f"soft-NMS per class: launches {counts} in "
                             f"{len(forwards)} forwards (want {want})")
    n_rois, _ = redo(plain_soft(True), "serial soft-NMS")
    report("soft-NMS per class", times, batch_ms, counts, n_rois,
           "serial soft-NMS")
    results["soft_nms_per_class"] = counts

    # 3. class-agnostic soft-NMS: the serial kernel
    m.nms_per_class = False
    times, batch_ms, counts, n_warm = serve(len(images), 2, True, False)
    want = {"hard_nms": 0, "soft_nms": len(forwards), "soft_nms_classes": 0,
            "dcn": 0}
    if counts != want:
        raise AssertionError(f"soft-NMS class-agnostic: launches {counts} "
                             f"in {len(forwards)} forwards (want {want})")
    n_rois, (boxes, scores, _) = redo(plain_soft(False), "serial soft-NMS")
    report("soft-NMS class-agnostic", times, batch_ms, counts, n_rois,
           "serial soft-NMS")
    results["soft_nms_class_agnostic"] = counts
    m.nms_type, m.nms_per_class = "nms", True
    served = time_soft_nms(
        torch, sn, f"request {sizes[3]}'s own {boxes.shape[1]} candidates, "
        "class-agnostic", (boxes, scores, None, None),
        dict(sigma=m.soft_nms_sigma, iou_threshold=m.nms_iou,
             score_threshold=m.soft_nms_score_threshold, method="gaussian",
             max_out=m.stage2_rois), card, before_soft)
    return results, served


def run_trident_path(torch, sn, hn, card):
    """Phase 6: the trires50deform backbone served (eval forwards at
    1x3x768x1408) and trained (train-mode steps at 4x3x512x512) through
    the DCN kernels; returns the (forward, backward) launch counts."""
    import contextlib
    from rrnet_torch.models.backbones import trident
    from rrnet_torch.ops import dcn
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.profile_trident import (SERVE_SHAPE, TRAIN_SHAPE,
                                             path_model, train_cotangents)

    seed = 7
    t0 = time.perf_counter()
    # build_backbone("trires50deform") with nonzero offset/mask convs
    model = path_model(seed)
    print(f"  trires50deform: {sum(p.numel() for p in model.parameters())} "
          f"params, f32, built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    @contextlib.contextmanager
    def dcn_as(fn):
        kernels = trident.deform_conv2d
        trident.deform_conv2d = fn
        try:
            yield
        finally:
            trident.deform_conv2d = kernels

    def kernel_forward_plain_backward(x, w, off, mask, bias=None, **kw):
        """The kernel's output, exactly, with the plain version's
        autograd behind it."""
        with torch.no_grad():
            k = tdc.deform_conv2d(x, w, off, mask, bias, **kw)
        p = dcn.deform_conv2d(x, w, off, mask, bias, **kw)
        return k + (p - p.detach())

    rng = np.random.RandomState(seed)
    x_serve = torch.from_numpy(rng.randn(*SERVE_SHAPE).astype(np.float32)
                               ).cuda()
    x_train = torch.from_numpy(rng.randn(*TRAIN_SHAPE).astype(np.float32)
                               ).cuda()
    cts = train_cotangents(seed)
    dcn_params = [n for n, _ in model.named_parameters()
                  if n.startswith("layer3_") and ".conv2." in n]
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    def serve():
        with torch.no_grad():
            return model.eval()(x_serve)

    def train_step():
        model.train()
        model.zero_grad(set_to_none=True)
        outs = model(x_train)
        outs[1].retain_grad()           # l2: the trident stage's input
        loss = sum((o * c).sum() / o.numel() for o, c in zip(outs, cts))
        loss.backward()
        return outs

    def timed(fn, n):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return out, ms

    def train_result(outs):
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if n in dcn_params}
        grads["l2 (input of the trident stage)"] = outs[1].grad.clone()
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        return [o.detach() for o in outs], grads, stats

    n_serve, n_train = 12, 6
    hn.launches = sn.launches = sn.classes_launches = 0     # every count
    tdc.fwd_launches = tdc.bwd_launches = 0                 # to 0
    serve_out, serve_ms = timed(serve, n_serve)
    _, train_ms = timed(train_step, n_train)
    model.load_state_dict(state0)
    train_out = train_result(train_step())
    torch.cuda.synchronize()
    fwd, bwd = tdc.fwd_launches, tdc.bwd_launches     # read just after
    soft = sn.launches + sn.classes_launches + hn.launches
    n_fwd = n_serve + n_train + 1
    if fwd != 15 * n_fwd or bwd != 15 * (n_train + 1) or soft != 0:
        raise AssertionError(f"trident path launched dcn_fwd {fwd}, dcn_bwd "
                             f"{bwd}, NMS {soft} times in {n_fwd} "
                             f"forwards and {n_train + 1} steps (want 15 "
                             "per forward, 15 per step, 0)")
    print(f"  launches: dcn_fwd {fwd} in {n_fwd} forwards ({fwd // n_fwd} "
          f"each), dcn_bwd {bwd} in {n_train + 1} steps "
          f"({bwd // (n_train + 1)} each)", flush=True)
    for o, shape in zip(serve_out, ((1, 256, 192, 352), (1, 512, 96, 176),
                                    (3, 1024, 48, 88), (3, 2048, 48, 88))):
        if tuple(o.shape) != shape or not torch.isfinite(o).all():
            raise AssertionError(f"serve map {tuple(o.shape)} (want {shape})"
                                 " or not finite")

    # the same model, same inputs and state: with the kernels' forward
    # and the plain version's backward, then with the plain DCN
    with dcn_as(kernel_forward_plain_backward):
        model.load_state_dict(state0)
        mixed = train_result(train_step())
    offs = []
    hook = model.layer3_1.conv2.offset_mask1.register_forward_hook(
        lambda m, a, o: offs.append(o[:, :72].detach()))
    with dcn_as(dcn.deform_conv2d):
        model.load_state_dict(state0)
        plain_serve, plain_serve_ms = timed(serve, 2)
        hook.remove()
        model.load_state_dict(state0)
        plain_train, plain_train_ms = timed(train_step, 2)
        model.load_state_dict(state0)
        plain_train = train_result(train_step())
    off = offs[-1]
    frac = off - torch.floor(off)
    print(f"  offsets of layer3_1 branch 1 at serve: mean |offset| "
          f"{float(off.abs().mean()):.3f}, max {float(off.abs().max()):.2f},"
          f" share off the integer grid (frac in [1e-3, 1-1e-3]) "
          f"{float(((frac > 1e-3) & (frac < 1 - 1e-3)).float().mean()):.4f}",
          flush=True)
    p50 = lambda ms: float(np.percentile(ms[1:], 50))      # noqa: E731
    print(f"  trident serve forward 1x3x768x1408 on {card}: p50 "
          f"{p50(serve_ms):.2f} ms over {n_serve - 1} after 1 warm-up "
          f"({[round(m, 2) for m in serve_ms]}); plain DCN, second of two "
          f"{plain_serve_ms[-1]:.2f} ms", flush=True)
    print(f"  trident train step 4x3x512x512 on {card}: p50 "
          f"{p50(train_ms):.2f} ms over {n_train - 1} after 1 warm-up "
          f"({[round(m, 2) for m in train_ms]}); plain DCN, second of two "
          f"{plain_train_ms[-1]:.2f} ms", flush=True)

    def rel(a, b):
        """(max |a-b| / max |b|, ||a-b|| / ||b||)"""
        d = (a - b).double()
        return (float(d.abs().max()) / max(float(b.abs().max()), 1e-30),
                float(d.norm()) / max(float(b.double().norm()), 1e-30))

    # Maps and running stats, kernels against the plain DCN: f32 sums in
    # another order, 1e-4 of the largest magnitude. Gradients, kernels
    # against the plain backward behind the kernels' forward: the same
    # forward values, so only the backward's sums differ, 1e-4. Against
    # the all-plain step the f32 gradients are ill-conditioned: a ReLU
    # input, or a sample coordinate, within rounding of 0 or of the
    # integer grid flips between two forwards and moves every gradient
    # upstream of it; that comparison is printed and held by the
    # relative norm only, 5e-2.
    checks = [(f"serve l{i + 1}", rel(a, b)[0], 1e-4)
              for i, (a, b) in enumerate(zip(serve_out, plain_serve))]
    checks += [(f"train l{i + 1}", rel(a, b)[0], 1e-4)
               for i, (a, b) in enumerate(zip(train_out[0], plain_train[0]))]
    checks += [("running stats", max(rel(train_out[2][k], plain_train[2][k])
                                     [0] for k in train_out[2]), 1e-4)]
    spread = []
    for k in train_out[1]:
        m_max, _ = rel(train_out[1][k], mixed[1][k])
        p_max, p_norm = rel(train_out[1][k], plain_train[1][k])
        checks.append((f"grad {k}", m_max, 1e-4))
        checks.append((f"grad {k} (all plain, norm)", p_norm, 5e-2))
        spread.append((k, m_max, p_max, p_norm))
    spread.sort(key=lambda r: -r[1])
    print(f"  {len(spread)} gradients (the DCN units' conv2 and "
          "offset_mask{i}, and l2), max |diff| / max |ref|, kernels vs the "
          "plain backward behind the kernels' forward: "
          + "; ".join(f"{k} {m:.3g}" for k, m, _, _ in spread[:4]), flush=True)
    spread.sort(key=lambda r: -r[3])
    print("  the same against the all-plain step, max and norm: "
          + "; ".join(f"{k} {m:.3g} / {n:.3g}" for k, _, m, n in spread[:4]),
          flush=True)
    worst = sorted(checks, key=lambda c: -c[1] / c[2])
    print("  worst checks against their tolerance: " + "; ".join(
        f"{n} {e:.3g} (tol {t:g})" for n, e, t in worst[:6])
        + f" (of {len(checks)})", flush=True)
    bad = [c for c in checks if not c[1] <= c[2]]
    if bad:
        raise AssertionError(f"trident path differs from the plain DCN: "
                             f"{bad}")
    return fwd, bwd


def run_train_path(torch, sn, hn, card):
    """Phase 7: the flagship RRNet's train step at full width at the
    preset's defaults (stage-1 hard NMS); returns the (hard_nms, soft_nms,
    soft_nms_classes) launch counts of the phase."""
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.ops.heatmap import topk_decode, topk_desc
    from rrnet_torch.profile_train import synthetic_batch, train_config
    from rrnet_torch.train import Trainer

    cfg = train_config()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(generator=torch.Generator().manual_seed(
        cfg.seed))
    model = trainer.model
    print(f"  trainer: {state.flat_params.numel()} params, "
          f"{state.flat_stats.numel()} BN statistics, {cfg.model.dtype} "
          f"compute, stage-1 {cfg.model.nms_type_for_stage1}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    batch = synthetic_batch(np.random.RandomState(cfg.seed))
    n_warm, n_timed, capture_at = 2, 8, 5
    seen = []

    def hook(module, args, out):
        if len(seen) == capture_at:       # one step's decoded candidates
            seen.append((out.hms[-1].detach().float(),
                         out.whs[-1].detach().float(),
                         out.offsets[-1].detach().float(),
                         out.rois.detach(), out.roi_scores, out.roi_classes,
                         out.roi_valid))
        else:
            seen.append(None)

    handle = model.register_forward_hook(hook)
    hn.launches = sn.launches = sn.classes_launches = 0     # every count
    tdc.fwd_launches = tdc.bwd_launches = 0                 # to 0
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for _ in range(n_warm + n_timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()

    # that step's own candidates: the plain fixpoint must select the
    # step's ROIs, and the class-parallel and the serial soft-NMS kernels
    # the same ROIs as each other (the forward's top-R choice,
    # models/rrnet.py, RRNet.select_rois)
    hm, wh, off, rois, roi_scores, roi_classes, roi_valid = seen[capture_at]

    def choose(masked):
        top, idx = topk_desc(masked, model.stage2_rois)
        valid = top > -torch.inf
        return (torch.gather(dets.boxes, 1, idx[..., None].expand(-1, -1, 4)),
                torch.where(valid, top, 0.0),
                torch.gather(dets.classes, 1, idx), valid)

    with torch.no_grad():
        dets = topk_decode(hm, wh, off, k=model.topk)
        keep = hn.hard_nms_reference(dets.boxes, dets.scores.contiguous(),
                                     model.nms_iou, None, dets.classes)
        plain = choose(torch.where(keep, dets.scores, -torch.inf))
        by_route = {}
        for route in (True, False):
            ns, keep, _ = sn.soft_nms_auto(
                dets.boxes, dets.scores.contiguous(), class_ids=dets.classes,
                num_classes=cfg.num_classes, class_parallel=route,
                sigma=model.soft_nms_sigma, iou_threshold=model.nms_iou,
                score_threshold=model.soft_nms_score_threshold,
                method="gaussian", max_out=model.stage2_rois)
            by_route[route] = choose(torch.where(keep, ns, -torch.inf))
    same = [torch.equal(a, b) for a, b in
            zip(plain, (rois, roi_scores, roi_classes, roi_valid))]
    same_soft = [torch.equal(a, b) for a, b in zip(by_route[True], by_route[False])]

    # a batch of inf pixels: skipped, and the state bitwise as it was
    def bits():
        return {k: (v.view(torch.int32) if v.is_floating_point() else v)
                .clone() for k, v in state.tensors().items()}
    before = bits()
    bad = dict(batch, images=np.full(batch["images"].shape, np.inf,
                                     np.float32))
    state, m_bad = trainer.train_step(state, bad)
    torch.cuda.synchronize()
    after = bits()
    hard, soft, classes = (hn.launches, sn.launches,
                           sn.classes_launches)          # read just after
    dcn = tdc.fwd_launches + tdc.bwd_launches
    handle.remove()

    n_fwd = len(seen)
    if hard != n_fwd or soft != 1 or classes != 1 or dcn:
        raise AssertionError(f"train path launched hard_nms {hard} times "
                             f"in {n_fwd} forwards (want 1 each), soft_nms "
                             f"{soft} and soft_nms_classes {classes} (want "
                             f"1 each, the cross-check), DCN {dcn} (want 0)")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite train losses: {metrics}")
    if not metrics[-1]["total"] < metrics[0]["total"] or any(
            m["skipped"] for m in metrics):
        raise AssertionError(f"train total did not fall: "
                             f"{[m['total'] for m in metrics]}")
    if not all(same):
        raise AssertionError(f"the plain hard-NMS fixpoint selected other "
                             f"ROIs than the step's kernel (rois, scores, "
                             f"classes, valid equal: {same})")
    if not all(same_soft):
        raise AssertionError(f"the serial soft-NMS kernel selected other "
                             f"ROIs than the class-parallel one on the "
                             f"step's candidates (rois, scores, classes, "
                             f"valid equal: {same_soft})")
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if float(m_bad["skipped"]) != 1.0 or changed:
        raise AssertionError(f"inf batch: skipped {float(m_bad['skipped'])},"
                             f" state changed in {changed}")
    print(f"  losses per step (hm, wh, off, s2, total): "
          + "; ".join(f"{m['hm']:.4f} {m['wh']:.4f} {m['off']:.4f} "
                      f"{m['s2']:.4f} {m['total']:.4f}" for m in metrics),
          flush=True)
    print(f"  launches: hard_nms {hard} in {n_fwd} forwards, soft_nms "
          f"{soft}, soft_nms_classes {classes}; step {capture_at + 1}'s ROI "
          f"selection == the plain fixpoint's ({int(roi_valid.sum())} ROIs), "
          f"and on its candidates the serial soft-NMS kernel selects the "
          f"class-parallel kernel's ROIs ({int(by_route[True][3].sum())}); inf "
          f"batch skipped with params, moments, counts, step and BN "
          f"statistics bitwise unchanged", flush=True)
    timed = ms[n_warm:]
    print(f"  train step 4x512x512 on {card}: p50 "
          f"{float(np.percentile(timed, 50)):.2f} ms, min {min(timed):.2f},"
          f" max {max(timed):.2f} over {n_timed} after {n_warm} warm-up "
          f"({[round(x, 2) for x in ms]}); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB", flush=True)
    return hard, soft, classes


def check_jpeg_route():
    """The JPEG route of this machine (PIL, `rrnet_torch/data/jpeg.py`):
    the demo frame's decode held to the 8x8-block means recorded from a
    CPU machine's PIL decode (tests/data/demo_jpeg_block_means.npy)
    within 2 LSB, an encode -> decode round trip of a seeded image at
    quality 92 at PSNR >= 38 dB, and a grayscale JPEG decoded to three
    equal channels. Returns what it measured."""
    import tempfile
    from rrnet_torch.data import jpeg
    img = jpeg.decode(os.path.join(HERE, "data", "demo", "images",
                                   "0000364_01765_d_0000782.jpg"))
    want = np.load(os.path.join(HERE, "tests", "data",
                                "demo_jpeg_block_means.npy"))
    bh, bw = want.shape[:2]
    got = img[:bh * 8, :bw * 8].astype(np.float64).reshape(
        bh, 8, bw, 8, 3).mean((1, 3))
    gap = float(np.abs(got - want).max())
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128]
    seeded = np.clip(np.stack([xx * 2, yy * 2, xx + yy], -1)
                     + rng.normal(0, 2, (96, 128, 3)), 0, 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as d:
        jpeg.encode(os.path.join(d, "a.jpg"), seeded, quality=92)
        back = jpeg.decode(os.path.join(d, "a.jpg"))
        jpeg.encode(os.path.join(d, "g.jpg"), seeded[..., 0], quality=95)
        gray = jpeg.decode(os.path.join(d, "g.jpg"))
    psnr = 10 * np.log10(255.0 ** 2 / np.mean(
        (back.astype(np.float64) - seeded) ** 2))
    gray_ok = gray.shape == (96, 128, 3) and bool(
        (gray[..., 0] == gray[..., 1]).all() and
        (gray[..., 1] == gray[..., 2]).all())
    print(f"  JPEG route: PIL ({jpeg.__name__}); demo frame {img.shape} "
          f"block means within {gap:.4f} LSB of the recorded ones "
          f"(bound 2); round trip at quality 92 {psnr:.2f} dB (bound 38); "
          f"grayscale decodes to 3 equal channels: {gray_ok}", flush=True)
    if gap > 2.0 or psnr < 38.0 or not gray_ok:
        raise AssertionError("the JPEG route failed its checks")
    return {"route": "pil", "demo_block_mean_gap": gap, "psnr_q92_db": psnr}


def run_data_path(torch, hn, card):
    """Phase 8: the data and eval path at the preset's full width. Makes
    the synthetic set, times `TrainLoader` alone (the preset's 4 threads,
    FillDuck with the roadmap), trains 20 steps at batch 4 through
    `TrainLoader` -> `DevicePrefetcher` -> `Trainer.train_step`, holds a
    checkpoint restored into a fresh Trainer bitwise to the state, runs
    `Evaluator.evaluate_split` over the 8 val images (held to
    `predict_batch` through `save_result`, byte for byte) and
    `evaluate_results`, and times `evaluate_split` on 16 frames of
    765x1360. Returns (the JSON "data" entry, hard_nms launches)."""
    import tempfile
    from rrnet_torch import config as cfglib
    from rrnet_torch.data import jpeg
    from rrnet_torch.data.loader import DevicePrefetcher, TrainLoader, ValLoader
    from rrnet_torch.data.synth import make_synth_dataset
    from rrnet_torch.data.transforms import _resize_image
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.evallib.metrics import evaluate_results
    from rrnet_torch.evallib.writer import save_result
    from rrnet_torch.train import Trainer
    from rrnet_torch.utils import checkpoint as ckpt

    entry = {"jpeg": check_jpeg_route()}
    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "synth")
    t0 = time.perf_counter()
    make_synth_dataset(root, n_train=32, n_val=8, seed=219)
    entry["synth_s"] = time.perf_counter() - t0
    print(f"  synthetic set (32 train + 8 val, seed 219) made in "
          f"{entry['synth_s']:.2f} s", flush=True)
    cfg = cfglib.apply_overrides(cfglib.rrnet_config(), [
        f"data_root={root}", "val.scales=(1.0,)", "val.flip_tta=False"])

    # the loader alone: 64 samples after one warm-up batch
    loader = TrainLoader(cfg, 4)
    try:
        loader.get_batch()
        t0 = time.perf_counter()
        for _ in range(16):
            loader.get_batch()
        rate = 64 / (time.perf_counter() - t0)
    finally:
        loader.close()
    entry["loader_samples_per_s"] = rate
    print(f"  TrainLoader alone ({cfg.train.num_workers} threads, FillDuck "
          f"with the roadmap, 512x512 crops): {rate:.2f} samples/s over 64 "
          f"samples on {os.cpu_count()} host cores; a 4x512x512 step of "
          f"~172 ms needs ~23", flush=True)

    # 20 steps through the prefetcher
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state()
    train_loader = TrainLoader(cfg, 4)
    pf = DevicePrefetcher(train_loader, device="cuda")
    step_ms, wait_ms, totals = [], [], []
    hn.launches = 0                                   # count this run only
    try:
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = pf.get_batch()
            t1 = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            totals.append(m["total"])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            wait_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t0) * 1e3)
    finally:
        pf.close()
    launches = hn.launches                            # read just after
    totals = [float(v) for v in totals]
    entry.update(step_p50_ms=float(np.percentile(step_ms[2:], 50)),
                 wait_p50_ms=float(np.percentile(wait_ms[2:], 50)),
                 loader_skips=train_loader.skips, hard_nms_launches=launches)
    print(f"  20 train steps 4x512x512 from the loader on {card}: step p50 "
          f"{entry['step_p50_ms']:.2f} ms, waiting on get_batch p50 "
          f"{entry['wait_p50_ms']:.2f} ms (steps 3-20; per step "
          f"{[round(x, 1) for x in step_ms]}, waits "
          f"{[round(x, 1) for x in wait_ms]}); loader skips "
          f"{train_loader.skips}; hard_nms launches {launches} in 20 "
          f"forwards; totals {[round(x, 4) for x in totals]}", flush=True)
    if train_loader.skips or launches != 20 or not all(
            np.isfinite(totals)):
        raise AssertionError(f"data path: {train_loader.skips} loader skips, "
                             f"{launches} hard_nms launches (want 0, 20), "
                             f"totals {totals}")

    # checkpoint -> a fresh Trainer
    path = ckpt.save_checkpoint(os.path.join(tmp.name, "log"), state)
    fresh = Trainer(cfg, device="cuda")
    restored = ckpt.restore_checkpoint(
        path, fresh.init_state(generator=torch.Generator().manual_seed(1)))
    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t
    diff = [k for k, v in state.tensors().items()
            if not torch.equal(bits(v), bits(restored.tensors()[k]))]
    print(f"  checkpoint at step {int(state.step)} restored into a fresh "
          f"Trainer: params, BN statistics, moments, counts and step bitwise "
          f"equal: {not diff}", flush=True)
    if diff:
        raise AssertionError(f"restored state differs in {diff}")
    del fresh, restored

    # evaluate_split over the val split, against predict_batch
    model = trainer.model
    model.load_state_dict(state.state_dict())
    ev = Evaluator(cfg, model, device="cuda")
    val = ValLoader(cfg)
    res = ev.evaluate_split(val, result_dir=os.path.join(tmp.name, "res"),
                            batch_size=4, verbose=False)
    items = list(val)
    buckets = {}                     # evaluate_split's batches: by bucket,
    for it in items:                 # leftovers padded with the last image
        h, w = it["image"].shape[:2]
        buckets.setdefault((-(-h // ev.bucket_multiple),
                            -(-w // ev.bucket_multiple)), []).append(it)
    same = True
    for group in (q[i:i + 4] for q in buckets.values()
                  for i in range(0, len(q), 4)):
        imgs = [g["image"] for g in group]
        for it, pred in zip(group, ev.predict_batch(
                imgs + imgs[-1:] * (4 - len(imgs)))):
            save_result(os.path.join(tmp.name, "direct.txt"), pred)
            with open(os.path.join(tmp.name, "direct.txt"), "rb") as f, \
                    open(os.path.join(res, it["name"] + ".txt"), "rb") as g:
                same = same and f.read() == g.read()
    ap = evaluate_results(res, os.path.join(root, "val", "annotations"),
                          verbose=False)
    entry["ap"] = {k: ap[k] for k in ("ap", "ap50", "ap75", "ar")}
    print(f"  evaluate_split over {len(items)} val images at batch 4: files "
          f"== predict_batch through save_result, byte for byte: {same}; "
          f"after 20 steps AP {ap['ap']:.4f} AP50 {ap['ap50']:.4f} AP75 "
          f"{ap['ap75']:.4f} AR {ap['ar']:.4f} (a record, not a bar)",
          flush=True)
    if not same:
        raise AssertionError("evaluate_split's files differ from "
                             "predict_batch's")

    # throughput: 16 frames of 765x1360 (the 768x1408 bucket), batch 4
    demo = jpeg.decode(os.path.join(HERE, "data", "demo", "images",
                                    "0000364_01765_d_0000782.jpg"))
    frame = _resize_image(demo, (1360, 765))
    frames = [{"name": f"f{i:02d}", "image": np.roll(frame, 37 * i, axis=1)}
              for i in range(16)]
    out_dir = os.path.join(tmp.name, "thr")
    ev.evaluate_split(frames[:4], result_dir=out_dir, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.evaluate_split(frames, result_dir=out_dir, batch_size=4,
                      verbose=False)
    secs = time.perf_counter() - t0
    entry["eval_images_per_s"] = 16 / secs
    print(f"  evaluate_split throughput, 16 frames 765x1360 in the 768x1408 "
          f"bucket at batch 4 on {card}: {16 / secs:.2f} images/s "
          f"({secs * 1e3:.1f} ms, files written)", flush=True)
    tmp.cleanup()
    return entry, launches


def main(argv=None) -> int:
    import argparse
    from pathlib import Path
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", metavar="DIR", help="a directory holding "
                    "another version of some of rrnet_torch/csrc's sources "
                    "(the DCN trio dcn_fwd.cu, dcn_bwd.cu, dcn_common.cuh; "
                    "soft_nms_classes.cu; soft_nms.cu), e.g. the parent "
                    "commit's; its kernels are built into DIR/build and "
                    "timed beside this checkout's, in turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rrnet_torch.ops import hard_nms as hn
    from rrnet_torch.ops import soft_nms as sn
    from rrnet_torch.utils import native

    phase("device")
    card = card_line()
    print(card, flush=True)
    jpeg_probe()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 at "
          f"PyTorch's defaults: cudnn.conv.fp32_precision="
          f"{torch.backends.cudnn.conv.fp32_precision!r}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    phase("build")
    t0 = time.perf_counter()
    native.build_all()
    secs = time.perf_counter() - t0
    print(f"  kernels {sorted(native.SOURCES)} built in {secs:.1f} s",
          flush=True)
    for name in native.SOURCES:
        for line in native.build_log(name):
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    before_pair = before_classes = before_soft = None
    if args.before:
        src = Path(args.before)
        t0 = time.perf_counter()
        if all((src / f).exists() for f in ("dcn_fwd.cu", "dcn_bwd.cu",
                                            "dcn_common.cuh")):
            before_pair = before_dcn(torch, src)
        if (src / "soft_nms_classes.cu").exists():
            before_classes = before_soft_nms_classes(torch, src)
        if (src / "soft_nms.cu").exists():
            before_soft = before_soft_nms(torch, src)
        if before_pair is None and before_classes is None and (
                before_soft is None):
            raise SystemExit(f"--before {src}: no DCN trio, no "
                             "soft_nms_classes.cu and no soft_nms.cu there")
        print(f"  the kernels of {src} ("
              + ", ".join(n for n, b in (("DCN", before_pair),
                                         ("soft_nms_classes",
                                          before_classes),
                                         ("soft_nms", before_soft)) if b)
              + f") built in {time.perf_counter() - t0:.1f} s", flush=True)

    phase("kernels vs plain")
    rng = np.random.RandomState(0)
    soft_err, soft_cases = check_soft_nms(torch, sn, rng)
    soft = soft_nms_timings(torch, sn, soft_cases, card, before_soft)
    soft["max_abs_err"] = soft_err
    classes = check_soft_nms_classes(torch, sn, rng, card, before_classes)
    hard = check_hard_nms(torch, hn, rng, card)
    dcn_fwd, dcn_bwd = check_dcn(torch, rng, card, before_pair)

    phase("small-input reference")
    check_small_reference(torch)
    check_small_train(torch)
    check_small_trident(torch)

    phase("main path")
    counts, soft["served_frame"] = run_main_path(torch, sn, hn, card,
                                                 before_soft)
    hard["launches"] = counts["defaults"]["hard_nms"]
    classes["launches"] = counts["soft_nms_per_class"]["soft_nms_classes"]
    soft["launches"] = counts["soft_nms_class_agnostic"]["soft_nms"]
    soft["class_agnostic"]["launches"] = soft["launches"]
    soft["flagship_launches"] = (counts["defaults"]["soft_nms"]
                                 + counts["soft_nms_per_class"]["soft_nms"])

    phase("trident path")
    dcn_fwd["launches"], dcn_bwd["launches"] = run_trident_path(
        torch, sn, hn, card)

    phase("train path")
    (hard["train_path_launches"], soft["train_path_launches"],
     classes["train_path_launches"]) = run_train_path(torch, sn, hn, card)

    phase("data and eval path")
    t0 = time.perf_counter()
    data, hard["data_path_launches"] = run_data_path(torch, hn, card)
    print(f"  phase took {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"data": data}), flush=True)
    print(json.dumps({"kernels": [soft, classes, dcn_fwd, dcn_bwd, hard]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
