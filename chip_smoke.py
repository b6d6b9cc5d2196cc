#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--before DIR]

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit from nvidia-smi, whether
     PIL and OpenCV import and where nvJPEG lies under the toolkit, and
     PyTorch's TF32 settings, which the run leaves at their defaults
     (the port pins its f32 convolutions to f32 itself);
  2. build: every CUDA kernel of the port from `rrnet_torch/csrc/`, one
     `nvcc` per source, and the host soft-NMS library (`g++`), all
     started together; ptxas register and spill lines;
  3. kernels: each kernel against its plain PyTorch version on the card
     at its path's shapes, plus edge cases, and timed against its bound;
     the serial soft-NMS timed class-agnostic at B=4 and B=1 and per
     class at B=4 with its selections per image (one pick, one barrier a
     step), and per class and class-agnostic at B=4 built with at most 8,
     16 and 24 warps a block; the class-parallel soft-NMS also against the
     serial kernel,
     with the busiest class's chain length per image beside its time; hard
     NMS against the plain fixpoint (NaN, +-0 and +-inf scores,
     thresholds 0 and -0.1, B=1 and 8, K=4096, 48-box chains among its
     cases); the DCN kernels against both bound
     routes (f32 on the CUDA cores, 3xTF32 on the tensor cores), the
     backward's two kernels apart; hard NMS also at RetinaNet's shape
     (B=4, K=1000, class-agnostic, thr 0.3, +1 extents, valid = score >
     0.1, decoded anchors crowded in one window); the conv epilogue at
     the eval cells' main shapes (4x256x288x544 bf16 and others) against
     its byte bound. `--before DIR` builds
     another version of the sources that DIR holds (the DCN trio,
     `soft_nms_classes.cu`, `soft_nms.cu`, `int8_conv.cu` with 5cd1773's
     C interface, `hard_nms.cu` with 0fe0581's: the wrapper's torch sort
     around it) and times it beside this checkout's, in turns
     ("before/after" lines; hard NMS's wrapper and device ms and device
     kernels a call at B=1, 4 and 8, K=1500 per class, and RetinaNet's
     B=4, K=1000; the int8 conv's device ms at every shape of
     the int8 check, and in phase 12 a served int8 forward with the other
     version's conv: p50 and the convs' device ms);
  4. small-input reference: a tiny RRNet (hard NMS and soft-NMS), a tiny
     RRNet train step (soft-NMS, its Adam update held to the CPU's in
     units of lr; hard NMS with the card's stage 2 fed the CPU's ROIs bit
     for bit) and trires50deform at 64x64, all f32, on the
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
     on 16 frames of 765x1360 at batch 4;
  9. eval protocol: the presets' own eval protocol at full width (bf16,
     seeded weights) over 8 frames of 765x1360 at batch 4: RRNet at the
     default val settings (six scales, `hard_nms` launched once a scale a
     batch, images/s, peak memory; the scale-1 program against a
     single-scale Evaluator), with `val.auto_test=False` (the host
     soft-NMS merge against its plain numpy version, ms an image) and
     with flip TTA (fused against unfused: recorded in bf16, held within
     1e-2 px and 1e-4 in f32); the device preprocess at
     scale 1.5 against the CPU's; CenterNet at its preset (train steps at
     4x512x512, then six scales with the fused flip, images/s);
 10. retinanet path: the `retinanet` preset at full width (ResNet-50,
     FPN-256, both towers, bf16, seeded weights): `Predictor` answers 16
     single 765x1360 requests and a batch of 4 (p50 / p90, one hard-NMS
     launch a forward, one request's keep mask against the plain
     fixpoint, decode + NMS under the sync debug mode "error", hard NMS
     timed on the batch's own candidates); `Trainer` takes 10 steps on one
     seeded batch of 4 uint8 512x512 crops (finite, falling; step p50,
     peak memory) and an inf batch that leaves the state bitwise;
     `evaluate_split` at the preset's protocol (scale 1, no flip, no host
     merge) over 8 frames at batch 4 (images/s); a resnet10 RetinaNet at
     2x3x64x64 f32 on the card against the CPU (outputs, rows, one train
     step's losses).
 11. hrnetv2-attention path: the `rrnet_hrnetv2_attention` preset at
     full width (HRNetV2-w40, the windowed self-attention on both stacks
     with each output projection W drawn nonzero, topk 1500, 512 ROIs,
     bf16, seeded weights): `Predictor` answers 16 single 765x1360
     requests and a batch of 4 (p50 / p90, one hard-NMS launch a
     forward, one request's keep mask and ROIs against the plain
     fixpoint, `select_rois` under the sync debug mode "error"), then
     per-class soft-NMS (one B.2 launch a forward, ROIs equal to the
     plain serial soft-NMS's); `Trainer` takes 10 steps on one seeded
     batch of 4 uint8 512x512 crops (finite, falling; step p50, peak
     memory; the frozen HRNetV2 BN statistics bitwise unchanged, the
     others moved) and an inf batch that leaves the state bitwise;
     `evaluate_split` at the preset's protocol (six scales, auto_test)
     over 8 frames at batch 4 (images/s, peak memory); the preset on a
     small HRNetV2 at 2x3x64x64 f32 and the dense and SE hourglass and
     ShuffleNetV2 0.5x at small size on the card against the CPU; a
     full-width bf16 forward of each of those three at 1x3x768x1408;
 12. int8 path: the `rrnet` preset at full width (bf16, seeded weights)
     through `Predictor(quantize="int8")` beside the bf16 `Predictor`:
     warmup refused before calibration, the calibration on 4 demo frames
     (162 convs, the JAX package's count), 16 requests each (p50 / p90;
     a forward launches 162 int8 convs, 162 quantize passes and one
     hard NMS), the detection agreement with bf16; `evaluate_split` at
     the six-scale protocol over 8 frames at batch 4, bf16 then int8
     (images/s, peak memory, launches); the centernet and retinanet
     presets' calibrated counts at full width (159 and 57); one int8
     forward of each of the three presets on a 765x1360 frame with a hook
     on `int8_conv2d`: the first call of each distinct geometry held
     bit-equal to the plain version;
 13. micro-batching: a `MicroBatcher` at its defaults over the bf16
     `rrnet` Predictor: 32 requests from 4 client threads at once and a
     closed loop of 16 beside single `predict` calls (requests/s, p50 /
     p90 from submit to result, the batch sizes), every future's rows
     held to its frame's single request (97% of the rows within 1e-2 px
     and 1e-4); then 8 requests with per-class soft-NMS (B.2 once a
     batch, one batch's ROIs equal to the plain serial soft-NMS's).
 14. data-parallel path: (a) two ranks on cuda:0, each a process of its
     own with a hard timeout, their collectives over gloo (NCCL puts no
     two ranks on one device), train the `rrnet` preset at full width
     (bf16, 2 crops of 512x512 a rank, SyncBN): 5 steps at the defaults
     (one hard-NMS launch a step on each rank), one with per-class
     soft-NMS (one B.2 launch on each rank), one with an inf batch on
     rank 1 alone (both skip, bitwise); then both ranks' params, moments,
     counts, step and SyncBN statistics are sha256-equal, and the step's
     collectives are timed alone; (b) in the same ranks, the tiny f32
     two-rank step on the card against the CPU; (c) a one-rank NCCL
     group joined from the environment (`parallel.init_from_env`): the
     full-width step p50 beside the plain Trainer's, in turns, and the
     765 MB flat gradient's all-reduce under NCCL and gloo; (d) `python
     -m rrnet_torch.scripts.eval --data-parallel` on the synthetic split
     writes result files byte-equal to the run without the flag. One
     card gives no multi-card number.
 15. reference tools path: (a) the flagship `rrnet` preset (full width,
     bf16, seeded weights) written out in the reference PyTorch code's
     checkpoint layout (`utils.convert.reference_state_dict`, wrapped as
     {"model": {"module." + key: tensor}}), `torch.save`d, read back by
     `load_torch_state_dict` and converted by `convert_detector_params`
     (no unexpected key, every tensor bit-equal), loaded strictly into
     a model of other seeded weights on the card; one `Predictor`
     request on the demo frame gives detections bit-equal to the first
     model's (convert and load seconds); (b) full-width forwards at
     1x3x768x1408 with a seeded roi_jitter of 1 feature px: the returned
     ROIs are the unjittered ROIs plus the jitter exactly, and a zero
     jitter changes no output bit; (c) `DCNPooling` at the reference
     defaults (pooled 7, output_dim 256, fc 1024, 4 samples a bin part,
     trans_std 0.1, `fc3` drawn nonzero) on the forward's relu'd stride-4
     map (1x256x192x352) and its 512 ROIs at spatial_scale 0.25, the card
     against the same module on the CPU within 1e-4 (ms a call); (d)
     k-means of the synthetic set's GT heights and widths (k 3) on the
     card against the CPU from the same init, assignments equal and
     centers within rtol 1e-5 (ms a call); (e) `utils.vis.visualize` of
     the served detections: its shape, and its box pixels equal to a
     numpy oracle that enumerates each edge's points.
The kernels phase also holds the int8 quantize-and-pack pass and the
int8 convolution bit-equal to their plain versions at the main path's
shapes (batch 1 and 4 of the 768x1408 bucket, stage 2 on 4x512 ROIs),
each timed beside its bound, cuDNN's bf16 convolution and, for 1x1
stride-1 shapes, `torch._int_mm`.
Each path runs with every launch count set to 0 just before it and read
just after. Then JSON lines hold the data path's, the eval protocol's,
the retinanet path's, the hrnetv2-attention path's, the int8 path's, the
micro-batching phase's, the data-parallel path's and the reference tools
path's numbers, one lists
every kernel,
and the last line is the result. It exits non-zero without a result when no CUDA device is
present.
"""

import contextlib
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
# Rate of the f32 and int32 operations that are not FMAs (add, sub, mul,
# min, max, compare): 132 SMs x 128 lanes x 1.98 GHz, half the data
# sheet's 67e12, which counts an FMA as two operations.
NON_FMA_OPS_PER_S = 33.5e12
# Least operations of hard NMS, counted on the inputs (`hard_nms_work`):
# one class compare a pair of valid boxes (when class ids are given); the
# four compares that find whether two boxes intersect, a same-class pair;
# the IoU test, an intersecting same-class pair (every same-class pair at
# thr < 0, where iou 0 > thr): iw and ih (min, max, sub, clamp each, and
# the +1 each with plus_one), inter, the union (add, sub, clamp), the
# divide and the threshold compare; each valid box's area once (two subs
# and a mul, two adds more with plus_one); K log2 K compares an image for
# the score order.
HARD_NMS_SCREEN_OPS = 4
HARD_NMS_IOU_OPS = 14
HARD_NMS_AREA_OPS = 3
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


def before_hard_nms(torch, src):
    """`hard_nms` built from another version of `hard_nms.cu` in `src`
    (0fe0581's C interface: the wrapper sorts by score with torch and
    passes the order and a scratch mask) into src/build, launched with that
    wrapper's work around it: the masked scores, `torch.sort`, the scratch
    and the launch. Takes `hard_nms`'s arguments; counts no launch."""
    import ctypes
    from pathlib import Path
    from rrnet_torch.utils import native
    src = Path(src)
    lib = native.build_all(("hard_nms",), src, src / "build")["hard_nms"]
    fn = ctypes.CDLL(str(lib)).rrnet_hard_nms
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(boxes, scores, iou_threshold, valid=None, class_ids=None,
            plus_one=False):
        bsz, k = scores.shape
        dev = boxes.device
        keep = torch.empty((bsz, k), dtype=torch.bool, device=dev)
        masked = scores if valid is None else torch.where(valid, scores,
                                                          -torch.inf)
        order = torch.sort(masked, dim=1, descending=True,
                           stable=True).indices
        scratch = torch.empty(bsz * (k + 1) * ((k + 63) // 64),
                              dtype=torch.int64, device=dev)
        err = fn(boxes.data_ptr(), order.data_ptr(),
                 None if valid is None else valid.data_ptr(),
                 None if class_ids is None else class_ids.data_ptr(),
                 scratch.data_ptr(), keep.data_ptr(), bsz, k, iou_threshold,
                 int(plus_one), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"hard_nms ({src}) launch failed: CUDA error "
                               f"{err}")
        return keep

    return run


def device_kernels_per_call(torch, fn, reps=5):
    """Device kernels a call of `fn` launches, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n / reps


def hard_nms_before_after(torch, hn, before, label, args, plus_one, card):
    """This checkout's `hard_nms` and the `--before` build on the same
    inputs, in turns (before, after, after, before): the wrapper ms a call
    (50 calls back to back), the device ms (torch.profiler) and the device
    kernels a call of each; both keep masks must agree (the inputs hold no
    NaN score, where the two orders differ). Returns the numbers."""
    versions = {"after": lambda: hn.hard_nms(*args, plus_one=plus_one),
                "before": lambda: before(*args, plus_one=plus_one)}
    if not torch.equal(versions["after"](), versions["before"]()):
        raise AssertionError(f"hard_nms {label}: the --before build keeps "
                             "other boxes")
    times = {v: [] for v in versions}
    for v in ("before", "after", "after", "before"):
        times[v].append(cuda_ms(versions[v], reps=50))
    out = {}
    for v, f in versions.items():
        out[v] = {"ms": float(np.mean(times[v])),
                  "device_ms": sum(device_split(torch, f, reps=20).values()),
                  "device_kernels": device_kernels_per_call(torch, f)}
    print(f"  hard_nms before/after, {label}, on {card}: "
          f"{out['before']['ms']:.4f} -> {out['after']['ms']:.4f} ms a call "
          f"({out['before']['ms'] / out['after']['ms']:.2f}x); device "
          f"{out['before']['device_ms']:.4f} -> "
          f"{out['after']['device_ms']:.4f} ms "
          f"({out['before']['device_ms'] / out['after']['device_ms']:.2f}x);"
          f" device kernels a call {out['before']['device_kernels']:g} -> "
          f"{out['after']['device_kernels']:g} (each ms the mean of two "
          "timings, before, after, after, before)", flush=True)
    return out


def hard_nms_work(torch, boxes, iou_threshold, valid=None, class_ids=None,
                  plus_one=False):
    """What hard NMS on these inputs needs at the least (the
    HARD_NMS_*_OPS above): the pairs of valid boxes, of them those of one
    class, of those the ones that take the IoU test (iw > 0 and ih > 0 as
    `ops.box.pairwise_iou` computes them; all of them at thr < 0), and
    the operations that makes, with the bytes of the inputs and the keep
    mask (boxes, scores, valid, class ids read once, keep written once)
    and the bound they give."""
    import math
    bsz, k = boxes.shape[:2]
    off = 1.0 if plus_one else 0.0
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    n_valid = valid_pairs = same = tested = 0
    for i in range(bsz):
        b = boxes[i]
        pair = upper
        if valid is not None:
            pair = pair & valid[i][:, None] & valid[i][None, :]
            n_valid += int(valid[i].sum())
        else:
            n_valid += k
        one = pair
        if class_ids is not None:
            one = pair & (class_ids[i][:, None] == class_ids[i][None, :])
        if iou_threshold >= 0:
            iw = (torch.minimum(b[:, None, 2], b[None, :, 2])
                  - torch.maximum(b[:, None, 0], b[None, :, 0]) + off)
            ih = (torch.minimum(b[:, None, 3], b[None, :, 3])
                  - torch.maximum(b[:, None, 1], b[None, :, 1]) + off)
            test = one & (iw > 0) & (ih > 0)
        else:
            test = one
        valid_pairs += int(pair.sum())
        same += int(one.sum())
        tested += int(test.sum())
    extra = 2 if plus_one else 0
    ops = ((valid_pairs if class_ids is not None else 0)
           + HARD_NMS_SCREEN_OPS * same
           + (HARD_NMS_IOU_OPS + extra) * tested
           + (HARD_NMS_AREA_OPS + extra) * n_valid
           + bsz * k * math.log2(max(k, 2)))
    nbytes = bsz * k * (16 + 4 + (1 if valid is not None else 0)
                        + (4 if class_ids is not None else 0) + 1)
    bound_ops = ops / NON_FMA_OPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"valid_pairs": valid_pairs, "same_class_pairs": same,
            "iou_tested_pairs": tested, "ops": ops, "bytes": nbytes,
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes"}


@contextlib.contextmanager
def recording_hard_nms(calls):
    """Within it, RRNet's forward records the arguments of each
    `hard_nms` call it makes (its own stage-1 candidates) into `calls`,
    as keyword dicts, and still launches the kernel."""
    from rrnet_torch.models import rrnet
    inner = rrnet.hard_nms
    names = ("boxes", "scores", "iou_threshold", "valid", "class_ids",
             "plus_one")

    def record(*args, **kw):
        calls.append({**dict(zip(names, args)), **kw})
        return inner(*args, **kw)

    rrnet.hard_nms = record
    try:
        yield calls
    finally:
        rrnet.hard_nms = inner


def hard_nms_on_traffic(torch, hn, label, run, per_run, card, before=None):
    """`hard_nms` on a phase's own candidates: its device ms a call inside
    `run` (one served forward, or one batch's six scales: `per_run` calls;
    device_split over one warm-up and two runs), the same calls timed
    back to back alone (with `before`, the `--before` build too, in turns:
    before, after, after, before), and what their pairs need
    (`hard_nms_work`, over the last run's calls), with the bound that
    gives; the scores' distinct values a call. Returns the numbers."""
    calls = []
    with recording_hard_nms(calls):
        split = device_split(torch, run, reps=2)
    calls = calls[-per_run:]
    in_run = sum(v for k, v in split.items() if "hard_nms_" in k) / per_run
    versions = {"after": hn.hard_nms}
    if before is not None:
        versions["before"] = before
    alone = {v: [] for v in versions}
    for v in ("before", "after", "after", "before"):
        if v in versions:
            alone[v].append(sum(sum(device_split(
                torch, lambda c=c: versions[v](**c), reps=20).values())
                for c in calls) / per_run)
    alone = {v: float(np.mean(t)) for v, t in alone.items()}
    distinct = [int(torch.unique(c["scores"]).numel()) for c in calls]
    work = {}
    for c in calls:
        w = hard_nms_work(torch, c["boxes"], c["iou_threshold"],
                          c.get("valid"), c.get("class_ids"),
                          c.get("plus_one", False))
        for k, v in w.items():
            if k != "bound_by":
                work[k] = work.get(k, 0) + v
    shape = list(calls[-1]["scores"].shape)
    out = {"shape": shape, "calls": per_run, "device_ms_in_run": in_run,
           "device_ms_alone": alone["after"],
           "before_device_ms_alone": alone.get("before"),
           "distinct_scores": distinct, "run_device_ms": sum(split.values()),
           "bound_ms": work["bound_ms"] / per_run,
           **{k: work[k] for k in ("valid_pairs", "same_class_pairs",
                                   "iou_tested_pairs")}}
    tested = work["iou_tested_pairs"]
    print(f"  hard_nms on {label} on {card}: {per_run} call(s) of "
          f"B={shape[0]} K={shape[1]}; device {in_run:.4f} ms a call inside "
          f"the run (of {out['run_device_ms']:.3f} ms of device time a "
          f"run), {alone['after']:.4f} ms alone"
          + (f" (the --before build {alone['before']:.4f} ms, in turns)"
             if before is not None else "")
          + f"; {distinct} distinct scores a call; of {work['valid_pairs']} "
          f"pairs {work['same_class_pairs']} of one class, {tested} of those "
          f"intersecting ({tested / max(work['same_class_pairs'], 1):.2%} "
          f"of one class, {tested / max(work['valid_pairs'], 1):.2%} of "
          f"all); bound {out['bound_ms']:.6f} ms a call", flush=True)
    return out


def hard_nms_chains(k, n=48):
    """In score order (scores fall with the index) the first n boxes of
    every 64 form a chain in which each suppresses the next at 0.5 (10 px
    wide, 2 px apart: IoU 0.667 with the next, 0.43 with the one after);
    the blocks lie 100 px apart, the other 64 - n boxes stand alone."""
    idx = np.arange(k)
    blk, pos = idx // 64, idx % 64
    x = np.where(pos < n, 2.0 * pos, 1000.0 + 20.0 * pos)
    y = 100.0 * blk
    boxes = np.stack([x, y, x + 10, y + 10], -1)[None].astype(np.float32)
    return boxes, np.linspace(1.0, 0.01, k, dtype=np.float32)[None]


def check_hard_nms(torch, hn, rng, card, before=None):
    """Hard NMS against the plain fixpoint on the card (keep bit-equal) at
    the stage-1 candidate shape, per class and class-agnostic, and edge
    cases: NaN scores (valid and invalid), +-0 and +-inf, thresholds 0 and
    -0.1, B=1 and B=8 (the fused flip's 2B) at K=1500, K=4096 at B=1, a
    48-box chain in every 64-block, bf16-valued scores (many ties) and one
    score for all; timed beside the plain fixpoint and against its bound,
    with the device kernels a call. With `before` (the `--before` build,
    `before_hard_nms`), both timed in turns at B=1, 4 and 8, K=1500 per
    class, at B=1 with bf16-valued scores, and at RetinaNet's B=4,
    K=1000. Returns the kernel's line."""
    from rrnet_torch.models.retinanet import NMS_IOU
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
    # the cases added with the one-launch kernel, from a generator of
    # their own (the later phases' draws stay as they were)
    own = np.random.RandomState(15)
    nan = scores.copy()
    nan[:, ::7] = np.nan
    odd = scores.copy()
    odd[:, ::5] = 0.0
    odd[:, 1::5] = -0.0
    odd[:, 2::11] = np.inf
    odd[:, 3::13] = -np.inf
    b1, s1, c1 = detections_like(own, 1, 1500, 10)
    b8, s8, c8 = detections_like(own, 8, 1500, 10)
    chains_b, chains_s = hard_nms_chains(1500)
    # scores as a bf16 forward gives them: 8 bits of mantissa, many ties
    tied = torch.from_numpy(scores).bfloat16().float().numpy()
    tied1 = torch.from_numpy(s1).bfloat16().float().numpy()
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
        ("NaN scores, valid and invalid", boxes, nan, mask, cls, 0.7, False),
        ("NaN scores, no mask, class-agnostic", boxes, nan, None, None, 0.7,
         False),
        ("+-0 and +-inf scores", boxes, odd, mask, cls, 0.7, False),
        ("thr 0", boxes, scores, mask, cls, 0.0, False),
        ("thr -0.1", boxes[:, :500], scores[:, :500], mask[:, :500],
         cls[:, :500], -0.1, False),
        ("thr -0.1, plus_one", boxes[:, :200], scores[:, :200], None, None,
         -0.1, True),
        ("B=1 K=1500", b1, s1, None, c1, 0.7, False),
        ("B=8 K=1500", b8, s8, None, c8, 0.7, False),
        ("K=4096 B=1", big_b[:1], big_s[:1], None, big_c[:1], 0.5, False),
        ("a chain of 48 in every 64-block", chains_b, chains_s, None, None,
         0.5, False),
        ("bf16-valued scores (ties)", boxes, tied, mask, cls, 0.7, False),
        ("bf16-valued scores, class-agnostic, +1", boxes, tied, None, None,
         0.5, True),
        ("K=4096 B=1 one score for all", big_b[:1],
         np.full((1, 4096), 0.25, np.float32), None, big_c[:1], 0.5, False),
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
    n_kernels = device_kernels_per_call(torch, lambda: hn.hard_nms(*args))
    plain_ms = cuda_ms(lambda: hn.hard_nms_reference(*args), reps=3, warm=1)
    work = hard_nms_work(torch, args[0], 0.7, None, args[4])
    print(f"  hard_nms timing at B=4 K=1500 per class on {card}: wrapper "
          f"{ms:.4f} ms a call (device {sum(split.values()):.4f} ms in "
          f"{n_kernels:g} device kernels a call: the hard_nms kernel "
          f"{kernels:.4f}, the score sort and the rest "
          f"{sum(split.values()) - kernels:.4f}), plain fixpoint "
          f"{plain_ms:.3f} ms, bound {work['bound_ms']:.6f} ms "
          f"({work['bound_by']}: {work['ops']:.4g} ops; of "
          f"{work['valid_pairs']} pairs {work['same_class_pairs']} of one "
          f"class, {work['iou_tested_pairs']} of those intersecting; "
          f"{work['bytes']} bytes); no PyTorch call computes NMS "
          "(torchvision is not installed), so library_ms is null; "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items())),
          flush=True)
    rb, rs, rv = retina_candidates_like(rng, 4, 1000)
    retina = time_hard_nms_retina(torch, hn, t(rb), t(rs), t(rv), card,
                                  "RetinaNet shape, B=4 K=1000")
    line = {"name": "hard_nms", "route": "cuda",
            "source": "rrnet_torch/csrc/hard_nms.cu",
            "replaces": "rrnet_tpu/ops/nms.py:46 (not a TPU kernel: the "
                        "XLA hard-NMS fixpoint)",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": work["bound_ms"],
            "bound_by": work["bound_by"], "library_ms": None,
            "device_ms": sum(split.values()), "kernels_device_ms": kernels,
            "device_kernels": n_kernels, "pairs": {
                k: work[k] for k in ("valid_pairs", "same_class_pairs",
                                     "iou_tested_pairs")},
            "retinanet_k1000": retina}
    if before is not None:
        line["before_after"] = {
            "B=1 K=1500 per class": hard_nms_before_after(
                torch, hn, before, "B=1 K=1500 per class",
                (t(b1), t(s1), 0.7, None, t(c1)), False, card),
            "B=1 K=1500 per class, bf16-valued scores": hard_nms_before_after(
                torch, hn, before, "B=1 K=1500 per class, bf16-valued scores",
                (t(b1), t(tied1), 0.7, None, t(c1)), False, card),
            "B=4 K=1500 per class": hard_nms_before_after(
                torch, hn, before, "B=4 K=1500 per class", args, False,
                card),
            "B=8 K=1500 per class": hard_nms_before_after(
                torch, hn, before, "B=8 K=1500 per class",
                (t(b8), t(s8), 0.7, None, t(c8)), False, card),
            "RetinaNet B=4 K=1000": hard_nms_before_after(
                torch, hn, before, "RetinaNet B=4 K=1000, class-agnostic, "
                f"thr {NMS_IOU}, +1", (t(rb), t(rs), NMS_IOU, t(rv)), True,
                card)}
    return line


def retina_candidates_like(rng, b, k, bucket=(768, 1408)):
    """RetinaNet's NMS input at its shape: per image k stride-8 anchors of
    the bucket drawn from one 96x96 px window (1296 anchors there, so the
    boxes crowd as the decode's top k do around objects), decoded with
    standardised deltas drawn from N(0, 0.5), uniform scores, and
    valid = score > 0.1."""
    from rrnet_torch.models.anchors import anchors_for_shape
    from rrnet_torch.models.retinanet import DELTA_STD, SCORE_THRESHOLD
    fh, fw = bucket[0] // 8, bucket[1] // 8
    level3 = anchors_for_shape(bucket)[:fh * fw * 9].reshape(fh, fw, 9, 4)
    boxes = np.empty((b, k, 4), np.float32)
    for i in range(b):
        y0, x0 = rng.randint(0, fh - 12), rng.randint(0, fw - 12)
        win = level3[y0:y0 + 12, x0:x0 + 12].reshape(-1, 4)
        a = win[rng.choice(len(win), k, replace=False)]
        d = rng.randn(k, 4).astype(np.float32) * 0.5
        aw, ah = a[:, 2] - a[:, 0], a[:, 3] - a[:, 1]
        cx = a[:, 0] + 0.5 * aw + d[:, 0] * DELTA_STD[0] * aw
        cy = a[:, 1] + 0.5 * ah + d[:, 1] * DELTA_STD[1] * ah
        w = np.exp(d[:, 2] * DELTA_STD[2]) * aw
        h = np.exp(d[:, 3] * DELTA_STD[3]) * ah
        boxes[i] = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            -1)
    scores = rng.rand(b, k).astype(np.float32)
    return boxes, scores, scores > SCORE_THRESHOLD


def time_hard_nms_retina(torch, hn, boxes, scores, valid, card, label):
    """RetinaNet's class-agnostic hard NMS (thr 0.3, +1 extents, valid
    mask) on these (B, K) candidates: the kernel's keep mask bit-equal to
    the plain fixpoint, then both timed (the wrapper also split into its
    device kernels by the profiler), beside the bound of what the
    candidates' pairs need (`hard_nms_work`). Returns the numbers."""
    from rrnet_torch.models.retinanet import NMS_IOU
    args = (boxes, scores, NMS_IOU, valid)
    got = hn.hard_nms(*args, plus_one=True)
    torch.cuda.synchronize()
    ref = hn.hard_nms_reference(*args, plus_one=True)
    if not torch.equal(got, ref):
        raise AssertionError(f"hard_nms kernel differs from the plain "
                             f"fixpoint ({label}): "
                             f"{int((got != ref).sum())} boxes")
    ms = cuda_ms(lambda: hn.hard_nms(*args, plus_one=True), reps=50)
    split = device_split(torch, lambda: hn.hard_nms(*args, plus_one=True),
                         reps=20)
    kernels = sum(v for k, v in split.items() if "hard_nms_" in k)
    plain_ms = cuda_ms(lambda: hn.hard_nms_reference(*args, plus_one=True),
                       reps=3, warm=1)
    bsz, kk = scores.shape
    work = hard_nms_work(torch, boxes, NMS_IOU, valid, None, True)
    out = {"shape": [bsz, kk], "valid": int(valid.sum()),
           "kept": int(got.sum()), "ms": ms, "plain_ms": plain_ms,
           "device_ms": sum(split.values()), "kernels_device_ms": kernels,
           "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
           "valid_pairs": work["valid_pairs"],
           "iou_tested_pairs": work["iou_tested_pairs"]}
    print(f"  hard_nms {label}: keep bit-equal to the plain fixpoint "
          f"({out['kept']} kept of {out['valid']} valid, B={bsz} K={kk}, "
          f"class-agnostic, thr {NMS_IOU}, +1); on {card}: {ms:.4f} ms a "
          f"call (device {out['device_ms']:.4f} ms: the hard_nms kernel "
          f"{kernels:.4f}, the rest {out['device_ms'] - kernels:.4f}), "
          f"plain fixpoint "
          f"{plain_ms:.3f} ms, bound "
          f"{out['bound_ms']:.6f} ms ({out['bound_by']}: {work['ops']:.4g} "
          f"ops; {work['valid_pairs']} valid pairs, "
          f"{work['iou_tested_pairs']} of them intersecting; "
          f"{work['bytes']} bytes)", flush=True)
    return out


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
    kink, is the one held with the card's own ROIs. Then one
    `train_step` on each device from the same state: losses within 1e-4,
    and the updated parameters held to the CPU's in units of lr
    (`small_train_update_gap`). The hooks that read the first forward's
    outputs return None and are removed after it: a forward hook that
    returns a value replaces the module's output."""
    cpu, gpu, state, batch = small_train_setup(torch, "soft_nms")
    outs = {}

    def capture(name):
        def hook(module, args, out):
            outs[name] = out          # returns None: the output stays
        return hook
    hooks = [tr.model.register_forward_hook(capture(name))
             for name, tr in (("cpu", cpu), ("cuda", gpu))]
    gstate = state.to("cuda")
    tot_c, g_c = cpu.loss_and_grads(state, batch)
    tot_g, g_g = gpu.loss_and_grads(gstate, batch)
    for h in hooks:
        h.remove()
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
    p0 = {k: v.clone() for k, v in state.params().items()}
    lr = float(state.schedule(state.sched_count))
    _, m_c = cpu.train_step(state, batch)
    _, m_g = gpu.train_step(gstate, batch)
    worst = max(abs(float(m_g[k]) - float(m_c[k]))
                / max(abs(float(m_c[k])), 1e-30) for k in m_c)
    if not worst <= 1e-4 or float(m_c["s2"]) <= 0:
        raise AssertionError(f"tiny train step losses cuda vs cpu: {m_c} / "
                             f"{m_g}")
    upd = small_train_update_gap(torch, p0, state, gstate, g_c, g_g, lr)
    print(f"  tiny RRNet train step f32 (soft-NMS) cuda == cpu: "
          f"{int(a.roi_valid.sum())} ROIs equal; losses within {worst:.3g} "
          f"(s2 {float(m_c['s2']):.4f}); {len(errs)} gradients within "
          f"{errs[0][0]:.3g} of their largest magnitude (worst "
          f"{errs[0][1]}); the update (lr {lr:.3g}): {upd['moved']:.4f} of "
          f"{upd['n']} params moved by >= lr / 2 on the CPU, "
          f"{upd['n'] - upd['loose']} within {UPDATE_TIGHT_LR:g} lr of the "
          f"CPU's step, {upd['loose']} ({upd['loose'] / upd['n']:.3g}) "
          f"further, up to {upd['worst']:.3g} lr, each within what its "
          f"gradient's gap allows through Adam's eps ({upd['near_zero']} "
          "elements with |g| within 2x the gap of 0)", flush=True)
    explain_small_train_gap(torch)


# a tiny train step's parameter update, card against CPU, in units of lr
UPDATE_TIGHT_LR = 1e-3


def small_train_update_gap(torch, p0, state, gstate, g_c, g_g, lr):
    """The first Adam step of the tiny train step on the card against the
    CPU's, each parameter's step (param' - param) in units of lr.

    Adam's first step is lr * g / (|g| + eps) elementwise (mu_hat = g,
    sqrt(nu_hat) = |g|), about lr * sign(g): it divides out the
    gradient's size, so the step's slope in g is eps / (|g| + eps)^2 and a
    card/CPU gradient gap d moves it by at most d * eps / (|g| - d + eps)^2
    lr where |g| > d (nothing where |g| >> eps, up to ~d / eps near
    eps), and by up to 2 lr, a flip of sign, where the gradient lies
    within d of 0. d is twice the tensor's measured max |g_g - g_c| (the
    step's `loss_and_grads`; twice, because the card's step recomputes its
    gradient and its scatter-adds run by atomics in another order). So
    every element must step within UPDATE_TIGHT_LR lr of the CPU plus that
    bound, and most within UPDATE_TIGHT_LR alone; a wrong rate or bias
    correction would move nearly every element by a good part of lr. And
    the update must really move: at least half of the parameters by
    lr / 2 on the CPU (with zero gradients nothing moves). Raises on a
    breach; returns the counts."""
    pc, pg = state.params(), gstate.params()
    n = loose = near_zero = moved = 0
    worst = 0.0
    for k, w0 in p0.items():
        step_c = (pc[k] - w0) / lr
        step_g = (pg[k].cpu() - w0) / lr
        gap = 2.0 * float((g_g[k].cpu() - g_c[k]).abs().max())
        gabs = g_c[k].abs()
        near = gabs <= gap
        slope = gap * state.eps / ((gabs - gap).clamp(min=0.0)
                                   + state.eps) ** 2
        allowed = torch.where(near, 2.0, slope.clamp(max=2.0)) \
            + UPDATE_TIGHT_LR
        d = (step_g - step_c).abs()
        if bool((d > allowed).any()):
            i = int(torch.argmax(d - allowed))
            raise AssertionError(
                f"tiny train step update of {k}, cuda vs cpu: "
                f"{int((d > allowed).sum())} elements step further apart "
                f"than the gradient gap {gap / 2:.3g} allows; worst "
                f"{float(d.flatten()[i]):.3g} lr at |g| "
                f"{float(gabs.flatten()[i]):.3g} (allowed "
                f"{float(allowed.flatten()[i]):.3g})")
        n += d.numel()
        loose += int((d > UPDATE_TIGHT_LR).sum())
        near_zero += int(near.sum())
        moved += int((step_c.abs() >= 0.5).sum())
        worst = max(worst, float(d.max()))
    if not moved >= 0.5 * n:
        raise AssertionError(f"tiny train step: only {moved} of {n} params "
                             "moved by lr / 2 on the CPU: no update")
    if not loose <= 0.01 * n:
        raise AssertionError(f"tiny train step: {loose} of {n} params step "
                             f"more than {UPDATE_TIGHT_LR:g} lr from the "
                             "CPU's (most must not)")
    if not (int(state.count) == int(gstate.count) == 1):
        raise AssertionError(f"tiny train step: Adam counts {int(state.count)}"
                             f" / {int(gstate.count)} after one step")
    return {"n": n, "loose": loose, "near_zero": near_zero,
            "moved": moved / n, "worst": worst}


def small_train_setup(torch, nms_type, group=None, batch_seed=4):
    """(cpu trainer, cuda trainer, state, batch) of the tiny f32 train
    step with stage-1 `nms_type`: half of the GT boxes are the CPU step's
    own ROIs, so stage 2 has positives. With a data-parallel `group` both
    trainers are ranks of it (the batch is this rank's share)."""
    from rrnet_torch import config
    from rrnet_torch.profile_train import synthetic_batch
    from rrnet_torch.train import Trainer
    cfg = config.rrnet_config(**{
        "model.backbone": "tiny_hourglass", "model.topk": 64,
        "model.stage2_rois": 16, "model.dtype": "float32",
        "model.nms_type_for_stage1": nms_type, "train.crop_size": (64, 64),
        "train.max_objects": 16, "train.stage2_warmup_steps": 0})
    cpu = Trainer(cfg, device="cpu", group=group)
    gpu = Trainer(cfg, device="cuda", group=group)
    state = cpu.init_state(generator=torch.Generator().manual_seed(1))
    params = state.params()
    with torch.no_grad():         # spread the logits: no near-ties
        for i in range(2):
            params[f"hm.out{i}.weight"].mul_(40.0)
    batch = synthetic_batch(np.random.RandomState(batch_seed), b=2,
                            hw=(64, 64),
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


def state_bits(torch, state):
    """A copy of every tensor of a train state, floats as their int32
    bits, for a bitwise comparison."""
    return {k: (v.view(torch.int32) if v.is_floating_point() else v).clone()
            for k, v in state.tensors().items()}


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


def run_main_path(torch, sn, hn, card, before_soft=None, before_hard=None):
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
    served_hard = hard_nms_on_traffic(
        torch, hn, f"request {sizes[3]}'s own candidates",
        lambda: pred.predict(images[3]), 1, card, before_hard)

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
    return results, served, served_hard


def run_trident_path(torch, sn, hn, card):
    """Phase 6: the trires50deform backbone served (eval forwards at
    1x3x768x1408) and trained (train-mode steps at 4x3x512x512) through
    the DCN kernels; returns the (forward, backward) launch counts."""
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
    before = state_bits(torch, state)
    bad = dict(batch, images=np.full(batch["images"].shape, np.inf,
                                     np.float32))
    state, m_bad = trainer.train_step(state, bad)
    torch.cuda.synchronize()
    after = state_bits(torch, state)
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


def match_rows(got, want, box_tol, score_tol):
    """Match one image's (N, 6) rows one to one: same class, score within
    score_tol, box within box_tol (rows with near-equal scores may come
    in either order). Returns (all matched and equal counts, the largest
    box gap and score gap over the matched rows, rows matched)."""
    used = np.zeros(len(want), bool)
    box_gap = score_gap = 0.0
    matched = 0
    for row in got:
        ok = (~used & (want[:, 5] == row[5])
              & (np.abs(want[:, 4] - row[4]) <= score_tol)
              & (np.abs(want[:, :4] - row[:4]).max(1) <= box_tol))
        if not ok.any():
            continue
        j = int(np.argmax(ok))
        used[j] = True
        matched += 1
        box_gap = max(box_gap, float(np.abs(want[j, :4] - row[:4]).max()))
        score_gap = max(score_gap, float(abs(want[j, 4] - row[4])))
    return (matched == len(got) == len(want), box_gap, score_gap, matched)


def demo_frames(n):
    """n frames of 765x1360: the demo frame resized as the data phase does,
    each rolled along x by another amount."""
    from rrnet_torch.data import jpeg
    from rrnet_torch.data.transforms import _resize_image
    demo = jpeg.decode(os.path.join(HERE, "data", "demo", "images",
                                    "0000364_01765_d_0000782.jpg"))
    frame = _resize_image(demo, (1360, 765))
    return [{"name": f"f{i:02d}", "image": np.roll(frame, 37 * i, axis=1)}
            for i in range(n)]


def run_eval_protocol(torch, hn, sn, card, before_hard=None):
    """Phase 9: the presets' own eval protocol at full width (bf16, seeded
    weights) over 8 frames of 765x1360 at batch 4. RRNet at its default
    val settings (six scales, no flip, auto_test): images/s, hard_nms
    launches (6 a batch), peak memory, and the scale-1 program's rows of
    one batch against a single-scale Evaluator's; with auto_test=False:
    the host merge against its plain version and its host ms per image;
    with flip TTA, fused against unfused (the gap recorded in bf16, the
    bound held on the same weights in f32). CenterNet at its preset: train
    steps at 4x512x512 and the protocol with the fused flip at six
    scales. The card's preprocess at scale 1.5 against the CPU's.
    Returns (the JSON "eval_protocol" entry, hard_nms launches of the
    RRNet run)."""
    import dataclasses
    import tempfile
    from rrnet_torch import config as cfglib
    from rrnet_torch.evallib import host_nms
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_model
    from rrnet_torch.ops import conv_epilogue as ce
    from rrnet_torch.profile_train import synthetic_batch
    from rrnet_torch.train import Trainer

    entry = {}
    frames = demo_frames(8)
    imgs = [f["image"] for f in frames[:4]]
    tmp = tempfile.TemporaryDirectory()

    def with_val(cfg, **kw):
        return cfg.replace(val=dataclasses.replace(cfg.val, **kw))

    def throughput(ev, label):
        """evaluate_split over the 8 frames at batch 4 after a warm-up
        over 4 (cuDNN plans of every scaled shape); images/s and the peak
        memory of the timed run."""
        out_dir = os.path.join(tmp.name, label)
        ev.evaluate_split(frames[:4], result_dir=out_dir, verbose=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ev.evaluate_split(frames, result_dir=out_dir, batch_size=4,
                          verbose=False)
        secs = time.perf_counter() - t0
        return 8 / secs, torch.cuda.max_memory_allocated(), out_dir

    # RRNet at the preset's default val settings
    cfg = cfglib.rrnet_config()
    scales = tuple(cfg.val.scales)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    ev = Evaluator(cfg, model, device="cuda")
    shapes = [ev._scaled_shape((768, 1408), sc) for sc in scales]
    print(f"  rrnet preset: scales {scales}, flip_tta {cfg.val.flip_tta}, "
          f"auto_test {cfg.val.auto_test}; scaled shapes of the 768x1408 "
          f"bucket {shapes}; model built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ev.evaluate_split(frames[:4], result_dir=os.path.join(tmp.name, "w"),
                      verbose=False)
    torch.cuda.synchronize()
    hn.launches = sn.launches = sn.classes_launches = 0    # count this run
    ce.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev.evaluate_split(frames, result_dir=os.path.join(tmp.name, "rr"),
                      batch_size=4, verbose=False)
    secs = time.perf_counter() - t0
    launches = hn.launches                                 # read just after
    epilogue_launches = ce.launches
    other = sn.launches + sn.classes_launches
    peak = torch.cuda.max_memory_allocated()
    entry["rrnet_six_scales"] = {
        "images_per_s": 8 / secs, "hard_nms_launches": launches,
        "hard_nms_launches_per_batch": launches / 2,
        "conv_epilogue_launches_per_batch": epilogue_launches / 2,
        "max_memory_allocated_gib": peak / 2**30}
    print(f"  rrnet, six scales, no flip, auto_test, 8 frames 765x1360 at "
          f"batch 4 on {card}: {8 / secs:.2f} images/s ({secs * 1e3:.1f} "
          f"ms, files written); hard_nms launches {launches} in 2 batches "
          f"(want 12: one a scale a batch), soft-NMS launches {other}, "
          f"conv_epilogue launches {epilogue_launches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    want_epilogues = len(scales) * 2 * RRNET_EPILOGUES_PER_FORWARD
    if (launches != 6 * 2 or other
            or epilogue_launches != want_epilogues):
        raise AssertionError(f"eval protocol: {launches} hard_nms launches "
                             f"(want 12), {other} soft-NMS launches (want 0), "
                             f"{epilogue_launches} conv_epilogue launches "
                             f"(want {want_epilogues}: every eval conv of "
                             f"every scale through the kernel)")
    entry["rrnet_six_scales"]["hard_nms"] = hard_nms_on_traffic(
        torch, hn, "a six-scale batch's own candidates",
        lambda: ev.gather(ev.dispatch_batch(imgs)), len(scales), card,
        before_hard)

    # the scale-1 program against a single-scale Evaluator
    single = Evaluator(with_val(cfg, scales=(1.0,)), model, device="cuda")
    pending, hws = ev.dispatch_batch(imgs)
    multi_rows = ev.gather((pending[:1], hws))       # the scale-1 program
    single_rows = single.predict_batch(imgs)
    bitwise = all(a.shape == b.shape and np.array_equal(a, b)
                  for a, b in zip(multi_rows, single_rows))
    res = [match_rows(a, b, 1e-3, 1e-5) for a, b in
           zip(multi_rows, single_rows)]
    print(f"  scale-1 program of the six-scale run against a single-scale "
          f"Evaluator, one batch of 4: bitwise equal {bitwise}; rows "
          f"matched {[r[3] for r in res]} of "
          f"{[len(b) for b in single_rows]}, largest gaps "
          f"{max(r[1] for r in res):.3g} px, {max(r[2] for r in res):.3g} "
          f"in score", flush=True)
    if not all(r[0] for r in res):
        raise AssertionError("the six-scale run's scale-1 rows differ from "
                             "a single-scale Evaluator's")

    # auto_test=False: the host merge, against its plain version
    merged_ev = Evaluator(with_val(cfg, auto_test=False), model,
                          device="cuda")
    pre = merged_ev.gather(merged_ev.dispatch_batch(imgs))
    t0 = time.perf_counter()
    merged = [merged_ev.merge(p) for p in pre]
    merge_ms = (time.perf_counter() - t0) * 1e3 / len(pre)
    def plain_merge(pred):
        # Evaluator.merge with the numpy soft-NMS in place of the library
        pred = pred[pred[:, 4] > cfg.val.score_threshold]
        pred = host_nms.per_class_soft_nms_xywh(
            pred, Nt=cfg.model.soft_nms.iou_threshold,
            threshold=cfg.model.soft_nms.score_threshold,
            soft_nms_fn=host_nms._soft_nms_numpy)
        return pred[np.argsort(-pred[:, 4], kind="stable")]

    t0 = time.perf_counter()
    plain = [plain_merge(p) for p in pre]
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(pre)
    # the plain version decays in numpy's f32 order, so scores differ in
    # the last bits and near-equal kept rows may swap places: rows are
    # matched (the same box and class), scores within 1e-5 (all <= 1)
    res = [match_rows(a, b, 0.0, 1e-5) for a, b in zip(merged, plain)]
    in_order = all(a.shape == b.shape and np.array_equal(a[:, [0, 1, 2, 3, 5]],
                                                         b[:, [0, 1, 2, 3, 5]])
                   for a, b in zip(merged, plain))
    merged_rate, _, _ = throughput(merged_ev, "merged")
    entry["host_merge"] = {"ms_per_image": merge_ms,
                           "evaluate_split_images_per_s": merged_rate,
                           "plain_ms_per_image": plain_ms,
                           "rows_in": [len(p) for p in pre],
                           "rows_out": [len(m) for m in merged],
                           "plain_rows_out": [len(p) for p in plain],
                           "max_score_gap": max(r[2] for r in res)}
    print(f"  auto_test=False: host merge (score filter, per-class soft-NMS "
          f"in the g++ library) {merge_ms:.2f} ms an image on the host, "
          f"plain numpy version {plain_ms:.2f} ms; rows "
          f"{entry['host_merge']['rows_in']} -> "
          f"{entry['host_merge']['rows_out']} (plain "
          f"{entry['host_merge']['plain_rows_out']}); matched "
          f"{[r[3] for r in res]} with equal boxes and classes, scores "
          f"within {entry['host_merge']['max_score_gap']:.3g} (bound "
          f"1e-5); in the same order: {in_order}; evaluate_split with the "
          f"merge, 8 frames at batch 4: {merged_rate:.2f} images/s", flush=True)
    if not all(r[0] for r in res):
        raise AssertionError("the host merge differs from its plain version")

    # flip TTA: fused (one 2B forward a scale) against unfused. In f32 (the
    # same weights) every row within 1e-2 px and 1e-4 in score. In bf16
    # cuDNN takes other algorithms for 2B images than for B, and a bf16
    # rounding flips some top-k or NMS choices of the random-weight model:
    # equal row counts, and at least 97% of each image's rows within
    # 1e-2 px and 1e-4 (98.39-98.76% in every run on an H100 80GB HBM3)
    def flip_gap(model_, dtype):
        flip_cfg = with_val(cfg, flip_tta=True)
        fused = Evaluator(flip_cfg, model_, device="cuda", fuse_flip=True)
        unfused = Evaluator(flip_cfg, model_, device="cuda", fuse_flip=False)
        a_rows, b_rows = fused.predict_batch(imgs), unfused.predict_batch(imgs)
        res = [match_rows(a, b, 1e-2, 1e-4) for a, b in zip(a_rows, b_rows)]
        wide = [match_rows(a, b, 1.0, 1e-4) for a, b in zip(a_rows, b_rows)]
        out = {"rows": [len(b) for b in b_rows],
               "matched": [r[3] for r in res],
               "max_box_gap_px": max(r[1] for r in res),
               "max_score_gap": max(r[2] for r in res),
               "matched_within_1px": [r[3] for r in wide],
               "max_box_gap_px_within_1px": max(r[1] for r in wide),
               "min_share_matched": min(r[3] / max(len(b), 1) for r, b
                                        in zip(res, b_rows))}
        print(f"  rrnet {dtype} with flip TTA at six scales, one batch of 4: "
              f"fused (2B a forward) against unfused: rows matched "
              f"{out['matched']} of {out['rows']} within 1e-2 px and 1e-4 "
              f"(largest gaps {out['max_box_gap_px']:.3g} px, "
              f"{out['max_score_gap']:.3g} in score); within 1 px "
              f"{out['matched_within_1px']}, largest gap "
              f"{out['max_box_gap_px_within_1px']:.3g} px", flush=True)
        same_rows = [len(a) for a in a_rows] == out["rows"]
        return out, same_rows, all(r[0] for r in res)

    bf16, same_rows, _ = flip_gap(model, "bf16")
    entry["flip_fused_vs_unfused_bf16"] = bf16
    if not same_rows or bf16["min_share_matched"] < 0.97:
        raise AssertionError(
            f"fused flip differs from unfused in bf16: row counts equal "
            f"{same_rows}, least share of an image's rows matched "
            f"{bf16['min_share_matched']:.4f} (bound 0.97)")
    f32_model = build_model(cfglib.rrnet_config(**{"model.dtype": "float32"}),
                            device="cuda")
    entry["flip_fused_vs_unfused_f32"], _, ok = flip_gap(f32_model, "f32")
    del f32_model
    if not ok:
        raise AssertionError("fused flip differs from unfused in f32")

    # the device resize at scale 1.5: the card against the CPU
    tiny = cfglib.rrnet_config(**{"model.backbone": "tiny_hourglass",
                                  "model.dtype": "float32"})
    cpu_ev = Evaluator(cfg, build_model(tiny, device="cpu"), device="cpu")
    scaled = ev._scaled_shape((768, 1408), 1.5)
    with torch.inference_mode():
        gx, gv = ev._preprocess(ev._upload(imgs), scaled, "both")
        cx, cv = cpu_ev._preprocess(cpu_ev._upload(imgs), scaled, "both")
    gap = float((gx.cpu() - cx).abs().max())
    same_vhw = torch.equal(gv.cpu(), cv)
    entry["resize_gap_scale_1_5"] = gap
    print(f"  device preprocess at scale 1.5 ({scaled}, flip both) on the "
          f"card against the CPU: largest gap {gap:.3g} (bound 1e-5), "
          f"scaled extents equal {same_vhw}", flush=True)
    if gap > 1e-5 or not same_vhw:
        raise AssertionError("the card's preprocess differs from the CPU's")
    del ev, single, merged_ev, model

    # CenterNet at its preset: train steps, then the protocol with flip
    ct = cfglib.centernet_config()
    trainer = Trainer(ct, device="cuda")
    state = trainer.init_state()
    batch = synthetic_batch(np.random.RandomState(ct.seed))
    torch.cuda.reset_peak_memory_stats()
    ms, totals = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        totals.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    finite = all(np.isfinite(list(t.values())).all() for t in totals)
    entry["centernet_train"] = {
        "step_p50_ms": float(np.percentile(ms[2:], 50)),
        "max_memory_allocated_gib": peak / 2**30,
        "totals": [t["total"] for t in totals]}
    print(f"  centernet preset train step, 4x512x512 {ct.model.dtype}, on "
          f"{card}: p50 {entry['centernet_train']['step_p50_ms']:.2f} ms "
          f"(steps 3-8; {[round(x, 1) for x in ms]}); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; losses finite {finite}; totals "
          f"{[round(t['total'], 4) for t in totals]}", flush=True)
    if not finite:
        raise AssertionError(f"centernet train losses not finite: {totals}")
    model = trainer.model.eval()
    model.load_state_dict(state.state_dict())
    ct_ev = Evaluator(ct, model, device="cuda")
    rate, peak, out_dir = throughput(ct_ev, "ct")
    n_rows = 0
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            n_rows += len(f.readlines())
    entry["centernet_six_scales_flip"] = {
        "images_per_s": rate, "max_memory_allocated_gib": peak / 2**30,
        "rows_written": n_rows}
    print(f"  centernet preset protocol (six scales, fused flip, k=250, "
          f"auto_test), 8 frames 765x1360 at batch 4 on {card}: "
          f"{rate:.2f} images/s; max_memory_allocated {peak / 2**30:.2f} "
          f"GiB; {n_rows} rows written", flush=True)
    if n_rows == 0:
        raise AssertionError("centernet eval wrote no detections")
    tmp.cleanup()
    return entry, launches


def check_small_retinanet(torch):
    """A resnet10 RetinaNet, f32, at 2x3x64x64: the card against the CPU
    on the same weights (the path the CPU tests hold to the JAX package).
    Outputs within 1e-4; the decoded rows (top 1000 of 756 anchors, hard
    NMS) matched one to one within 1e-3 px and 1e-5 (the cls out-conv is
    scaled by 10 to spread the scores, as in the CPU test); one train
    step's losses within 1e-4."""
    from rrnet_torch import config as cfglib
    from rrnet_torch.models import build_model, retinanet
    from rrnet_torch.models.anchors import anchors_for_shape
    from rrnet_torch.profile_train import synthetic_batch
    from rrnet_torch.train import Trainer

    cfg = cfglib.retinanet_config(**{
        "model.backbone": "resnet10", "model.dtype": "float32",
        "train.crop_size": (64, 64), "train.max_objects": 16})
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        cpu.cls.out.weight.mul_(10.0)
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 64, 64)
                         .astype(np.float32))
    vhw = torch.tensor([[64, 64], [50, 60]], dtype=torch.int32)
    anchors = torch.from_numpy(anchors_for_shape((64, 64)).copy())
    with torch.inference_mode():
        a = cpu(x)
        b = gpu(x.cuda())
        ra = retinanet.decode(*a, anchors, vhw, len(anchors))
        rb = retinanet.decode(*b, anchors.cuda(), vhw.cuda(), len(anchors))
    for name, u, v in (("loc", a[0], b[0]), ("cls", a[1], b[1])):
        torch.testing.assert_close(v.cpu(), u, atol=1e-4, rtol=0,
                                   msg=f"resnet10 RetinaNet {name}")
    gaps = []
    for u, v in zip(ra.numpy().astype(np.float64),
                    rb.cpu().numpy().astype(np.float64)):
        u, v = u[u[:, 4] >= 0], v[v[:, 4] >= 0]
        ok, box_gap, score_gap, matched = match_rows(v, u, 1e-3, 1e-5)
        if not ok:
            raise AssertionError(f"resnet10 RetinaNet rows cuda vs cpu: "
                                 f"{matched} of {len(u)} / {len(v)} matched")
        gaps.append((len(u), box_gap, score_gap))

    trainers = [Trainer(cfg, device=d) for d in ("cpu", "cuda")]
    state = trainers[0].init_state(generator=torch.Generator().manual_seed(5))
    batch = synthetic_batch(np.random.RandomState(6), b=2, hw=(64, 64),
                            max_objects=16, n_valid=(4, 12),
                            size=(8.0, 40.0))
    metrics = []
    for tr, st in zip(trainers, (state, state.to("cuda"))):
        _, m = tr.train_step(st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    worst = max(abs(metrics[1][k] - metrics[0][k])
                / max(abs(metrics[0][k]), 1e-30) for k in metrics[0])
    if not worst <= 1e-4 or metrics[0]["reg"] <= 0:
        raise AssertionError(f"resnet10 RetinaNet train step cuda vs cpu: "
                             f"{metrics}")
    print(f"  resnet10 RetinaNet f32 2x3x64x64 cuda == cpu: loc/cls within "
          f"1e-4; rows (count, box gap px, score gap) {gaps}; one train "
          f"step's losses within {worst:.3g} ({metrics[0]})", flush=True)


def run_retinanet_path(torch, sn, hn, card):
    """Phase 10: the `retinanet` preset at full width (ResNet-50, FPN-256,
    both towers, bf16, seeded random weights). Serving: `Predictor`
    answers single 765x1360 requests and one batch of 4 in the 768x1408
    bucket (p50 / p90), one hard-NMS launch a forward; one request's keep
    mask redone by the plain fixpoint on the same candidates, and the
    decode with its NMS run once under `torch.cuda.set_sync_debug_mode(
    "error")`; `hard_nms` timed on the batch's own candidates. Training:
    `Trainer` takes 10 steps on one seeded batch of 4 uint8 512x512 crops
    (finite, falling total; step p50, peak memory), then an inf batch
    that must leave the state bitwise as it was. Evaluation:
    `evaluate_split` at the preset's protocol (scale 1, no flip, no host
    merge) over 8 frames of 765x1360 at batch 4 (images/s). Then the
    small-input reference. Each part runs with every launch count set to
    0 just before it and read just after. Returns (the JSON "retinanet"
    entry, hard_nms launches of the serving run)."""
    import tempfile
    from rrnet_torch import config as cfglib
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_model, retinanet
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.profile_train import synthetic_batch
    from rrnet_torch.serving import Predictor
    from rrnet_torch.train import Trainer

    def zero_counts():
        hn.launches = sn.launches = sn.classes_launches = 0
        tdc.fwd_launches = tdc.bwd_launches = 0

    def read_counts():
        return {"hard_nms": hn.launches, "soft_nms": sn.launches,
                "soft_nms_classes": sn.classes_launches,
                "dcn": tdc.fwd_launches + tdc.bwd_launches}

    cfg = cfglib.retinanet_config()
    entry = {}
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  retinanet preset: {cfg.model.backbone}, FPN "
          f"{cfg.model.fpn_channels}, {cfg.model.dtype}, {n_params} params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    if n_params != 30_617_534:
        raise AssertionError(f"retinanet preset has {n_params} params")

    # --- serving
    pred = Predictor(cfg, model, device="cuda")
    ev = pred._ev
    forwards = []
    hook = model.register_forward_hook(
        lambda module, args, out: forwards.append(out))
    frames = demo_frames(16)
    images = [f["image"] for f in frames]
    pred.warmup(((765, 1360),), batch_sizes=(1, 4))
    torch.cuda.synchronize()
    forwards.clear()
    zero_counts()
    ms = []
    outs = []
    for im in images:
        t = time.perf_counter()
        outs.append(pred.predict(im))
        ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    outs += pred.predict_batch(images[:4])
    batch_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    counts = read_counts()                                   # just after
    hook.remove()
    n_fwd = len(forwards)
    if counts != {"hard_nms": n_fwd, "soft_nms": 0, "soft_nms_classes": 0,
                  "dcn": 0} or n_fwd != len(images) + 1:
        raise AssertionError(f"retinanet serving: launches {counts} in "
                             f"{n_fwd} forwards (want one hard_nms each)")
    for d in outs:
        check_detections(d, 1000, cfg.num_classes)
    p50, p90 = (float(np.percentile(ms, q)) for q in (50, 90))
    entry["serve"] = {"p50_ms": p50, "p90_ms": p90, "batch4_ms": batch_ms,
                      "requests": len(ms), "hard_nms_launches": counts[
                          "hard_nms"], "rows": [len(d) for d in outs]}
    print(f"  retinanet serving on {card}: {len(ms)} single 765x1360 "
          f"requests p50 {p50:.2f} ms, p90 {p90:.2f} ms (min {min(ms):.2f}, "
          f"max {max(ms):.2f}); a batch of 4 {batch_ms:.2f} ms; hard_nms "
          f"launches {counts['hard_nms']} in {n_fwd} forwards; rows per "
          f"request {[len(d) for d in outs[:4]]}...", flush=True)

    # one request's candidates: the kernel's keep mask against the plain
    # fixpoint, and decode + NMS under the sync debug mode
    staged = ev._upload([images[0]])
    with torch.inference_mode():
        x, vhw = ev._preprocess(staged, staged.bucket, False)
        loc, cls = model(x)
        anchors = ev.anchors_for(tuple(x.shape[-2:]))
        topk = min(4 * ev.decode_topk, anchors.shape[0])
        c = retinanet.candidates(loc, cls, anchors, vhw, topk)
        keep = retinanet.nms(c)
        torch.cuda.synchronize()
        ref = hn.hard_nms_reference(c.boxes, c.scores, retinanet.NMS_IOU,
                                    c.valid, plus_one=True)
        if not torch.equal(keep, ref):
            raise AssertionError(f"retinanet request: hard_nms keep differs "
                                 f"from the plain fixpoint in "
                                 f"{int((keep != ref).sum())} of {topk}")
        rows = int((keep & c.valid).sum())
        if rows != len(outs[0]):
            raise AssertionError(f"retinanet request: {rows} kept rows, the "
                                 f"Predictor returned {len(outs[0])}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            packed = retinanet.decode(loc, cls, anchors, vhw, topk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if int((packed[..., 4] >= 0).sum()) != rows:
            raise AssertionError("retinanet decode under the sync debug "
                                 "mode gave other rows")
    print(f"  retinanet request: {topk} candidates of {anchors.shape[0]} "
          f"anchors, {int(c.valid.sum())} valid, {rows} kept; the kernel's "
          f"keep mask bit-equal to the plain fixpoint; decode + NMS ran "
          f"under set_sync_debug_mode('error') with no host sync", flush=True)

    # the batch of 4's own candidates: hard_nms timed at RetinaNet's shape
    staged = ev._upload(images[:4])
    with torch.inference_mode():
        x, vhw = ev._preprocess(staged, staged.bucket, False)
        c = retinanet.candidates(*model(x), anchors, vhw, topk)
        entry["hard_nms_batch4"] = time_hard_nms_retina(
            torch, hn, c.boxes, c.scores, c.valid, card,
            "on a served batch of 4's own candidates")
    del pred, ev

    # --- training
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(generator=torch.Generator().manual_seed(
        cfg.seed))
    batch = synthetic_batch(np.random.RandomState(cfg.seed))
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()

    before = state_bits(torch, state)
    bad = dict(batch, images=np.full(batch["images"].shape, np.inf,
                                     np.float32))
    state, m_bad = trainer.train_step(state, bad)
    torch.cuda.synchronize()
    after = state_bits(torch, state)
    counts = read_counts()                                   # just after
    if any(counts.values()):
        raise AssertionError(f"retinanet train steps launched {counts}")
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite retinanet losses: {metrics}")
    totals = [m["total"] for m in metrics]
    if not totals[-1] < totals[0] or any(m["skipped"] for m in metrics):
        raise AssertionError(f"retinanet train total did not fall: {totals}")
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if float(m_bad["skipped"]) != 1.0 or changed:
        raise AssertionError(f"retinanet inf batch: skipped "
                             f"{float(m_bad['skipped'])}, state changed in "
                             f"{changed}")
    timed = ms[2:]
    entry["train"] = {"step_p50_ms": float(np.percentile(timed, 50)),
                      "max_memory_allocated_gib": peak / 2**30,
                      "totals": totals, "step_ms": ms}
    print(f"  retinanet train step 4x512x512 {cfg.model.dtype} on {card}: p50 "
          f"{entry['train']['step_p50_ms']:.2f} ms (steps 3-10; "
          f"{[round(x, 1) for x in ms]}); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; (cls, reg, total) per step "
          + "; ".join(f"{m['cls']:.4f} {m['reg']:.4f} {m['total']:.4f}"
                      for m in metrics)
          + "; inf batch skipped with the state bitwise unchanged",
          flush=True)

    # --- evaluation at the preset's protocol
    model = trainer.model.eval()
    model.load_state_dict(state.state_dict())
    ev = Evaluator(cfg, model, device="cuda")
    tmp = tempfile.TemporaryDirectory()
    ev.evaluate_split(frames[:4], result_dir=os.path.join(tmp.name, "w"),
                      verbose=False)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out_dir = ev.evaluate_split(frames[:8], result_dir=os.path.join(
        tmp.name, "rt"), batch_size=4, verbose=False)
    secs = time.perf_counter() - t0
    counts = read_counts()                                   # just after
    n_rows = 0
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            n_rows += len(f.readlines())
    tmp.cleanup()
    if counts != {"hard_nms": 2, "soft_nms": 0, "soft_nms_classes": 0,
                  "dcn": 0} or n_rows == 0:
        raise AssertionError(f"retinanet eval: launches {counts} (want 2 "
                             f"hard_nms), {n_rows} rows written")
    entry["eval"] = {"images_per_s": 8 / secs, "hard_nms_launches": 2,
                     "rows_written": n_rows}
    print(f"  retinanet preset protocol (scale 1, no flip, no host merge), "
          f"8 frames 765x1360 at batch 4 on {card}: {8 / secs:.2f} images/s "
          f"({secs * 1e3:.1f} ms, files written); hard_nms launches 2 in 2 "
          f"batches; {n_rows} rows written", flush=True)
    del trainer, state, model, ev

    check_small_retinanet(torch)
    return entry, entry["serve"]["hard_nms_launches"]


SMALL_HRNET = dict(base_channels=8, stage_modules=(1, 1, 1))


def draw_attention_w(torch, named, generator):
    """Each `attention{i}.W` tensor among `named` ((name, tensor) pairs:
    a model's parameters or a TrainState's views; zero at init, when the
    module adds exactly 0) drawn from `generator`: U(+-1/sqrt(fan_in)) on
    the kernel, N(0, 0.1) on the bias. Returns the names drawn."""
    drawn = []
    with torch.no_grad():
        for name, p in named:
            if ".W." not in name:
                continue
            if p.dim() == 4:
                v = (torch.rand(p.shape, generator=generator) * 2 - 1) / (
                    p.shape[1] ** 0.5)
            else:
                v = torch.randn(p.shape, generator=generator) * 0.1
            p.copy_(v)
            drawn.append(name)
    return drawn


class small_hrnet_backbone:
    """Inside the block RRNet builds the small HRNetV2 (base 8, modules
    (1, 1, 1)) whatever backbone its config names."""

    def __enter__(self):
        from rrnet_torch.models import rrnet as rrnet_mod
        from rrnet_torch.models.backbones.hrnetv2 import HRNetV2
        self.mod, self.real = rrnet_mod, rrnet_mod.get_backbone
        rrnet_mod.get_backbone = (lambda name, num_stacks=2, dtype=None:
                                  HRNetV2(dtype=dtype, **SMALL_HRNET))

    def __exit__(self, *exc):
        self.mod.get_backbone = self.real


def check_small_hrnet_attention(torch):
    """The preset on the small HRNetV2 (attention on both stacks, every W
    drawn nonzero), f32, at 2x3x64x64: the card against the CPU on the
    same weights (the path the CPU tests hold to the JAX package):
    heads within 1e-4, ROIs, classes and validity; then one train step's
    losses within 1e-4 and its BN statistics (the backbone's unchanged
    on both). Then the rest of the registry at small size, card against
    CPU: the dense and the SE hourglass (depth 2, inplanes (64, 64, 96);
    256 and 64 features), ShuffleNetV2 0.5x, each map within 1e-4 of its
    largest magnitude."""
    from rrnet_torch import config as cfglib
    from rrnet_torch.models import build_model
    from rrnet_torch.models.backbones.hourglass import HourglassNet
    from rrnet_torch.models.backbones.shufflenet import ShuffleNetV2
    from rrnet_torch.models.layers import init_weights
    from rrnet_torch.profile_train import synthetic_batch
    from rrnet_torch.train import Trainer

    cfg = cfglib.rrnet_hrnetv2_attention_config(**{
        "model.topk": 64, "model.stage2_rois": 16, "model.dtype": "float32",
        "train.crop_size": (64, 64), "train.max_objects": 16,
        "train.stage2_warmup_steps": 0})
    gen = torch.Generator().manual_seed(11)
    with small_hrnet_backbone():
        cpu = build_model(cfg, device="cpu", generator=gen)
        gpu = build_model(cfg, device="cuda", generator=gen)
    draw_attention_w(torch, cpu.named_parameters(), gen)
    with torch.no_grad():
        for i in range(2):
            getattr(cpu.hm, f"out{i}").weight.mul_(4.0)
            for h in ("hconv", "wconv"):
                getattr(cpu.wh, f"{h}{i}").bias.add_(3.0)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(12).randn(2, 3, 64, 64)
                         .astype(np.float32))
    vhw = torch.tensor([[64, 64], [52, 60]], dtype=torch.int32)
    with torch.inference_mode():
        att = cpu.attention1(torch.relu(cpu.backbone(x)[1]))
        a = cpu(x, valid_hw=vhw)
        b = gpu(x.cuda(), valid_hw=vhw.cuda())
    if not float(att.abs().max()) > 1e-3:
        raise AssertionError("small HRNetV2 preset: the attention adds 0")
    for name in ("roi_valid", "roi_classes"):
        if not torch.equal(getattr(a, name), getattr(b, name).cpu()):
            raise AssertionError(f"small HRNetV2 preset f32: {name} differ "
                                 "cuda vs cpu")
    torch.testing.assert_close(b.rois.cpu(), a.rois, atol=1e-3, rtol=0)
    for k in ("hms", "whs", "offsets"):
        for u, v in zip(getattr(a, k), getattr(b, k)):
            torch.testing.assert_close(v.cpu(), u, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(b.stage2_reg.cpu(), a.stage2_reg, atol=1e-4,
                               rtol=1e-4)

    with small_hrnet_backbone():
        trainers = [Trainer(cfg, device=d) for d in ("cpu", "cuda")]
        state = trainers[0].init_state(
            generator=torch.Generator().manual_seed(13))
    draw_attention_w(torch, state.params().items(),
                     torch.Generator().manual_seed(14))
    batch = synthetic_batch(np.random.RandomState(15), b=2, hw=(64, 64),
                            max_objects=16, n_valid=(4, 12),
                            size=(8.0, 40.0))
    metrics, stats = [], []
    before = {k: v.clone() for k, v in state.batch_stats().items()}
    for tr, st in zip(trainers, (state, state.to("cuda"))):
        st, m = tr.train_step(st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        stats.append({k: v.cpu() for k, v in st.batch_stats().items()})
    worst = max(abs(metrics[1][k] - metrics[0][k])
                / max(abs(metrics[0][k]), 1e-30) for k in metrics[0])
    if not worst <= 1e-4:
        raise AssertionError(f"small HRNetV2 preset train step cuda vs cpu: "
                             f"{metrics}")
    for k, v in before.items():
        frozen = k.startswith("backbone.")
        for s in stats:
            if torch.equal(s[k], v) != frozen:
                raise AssertionError(f"small HRNetV2 preset train step: "
                                     f"{k} {'moved' if frozen else 'stuck'}")
        torch.testing.assert_close(stats[1][k], stats[0][k], atol=1e-4,
                                   rtol=1e-4)
    print(f"  small HRNetV2 preset f32 2x3x64x64 cuda == cpu: "
          f"{int(a.roi_valid.sum())} ROIs, classes/validity equal, boxes "
          f"within 1e-3, heads within 1e-4, attention adds up to "
          f"{float(att.abs().max()):.3g}; one train step's losses within "
          f"{worst:.3g} ({metrics[0]}); backbone BN statistics unchanged "
          f"on both, the others moved alike", flush=True)

    small = {"dense_hourglass": lambda: HourglassNet(
                 depth=2, inplanes=(64, 64, 96), layer_nums=(1, 1, 1),
                 num_feats=256, dense=True),
             "se_hourglass": lambda: HourglassNet(
                 depth=2, inplanes=(64, 64, 96), layer_nums=(1, 1, 1),
                 num_feats=64, se=True, pool_stem=True),
             "shufflenet_0.5x": lambda: ShuffleNetV2("0.5x")}
    x = torch.from_numpy(np.random.RandomState(16).randn(2, 3, 64, 64)
                         .astype(np.float32))
    for name, make in small.items():
        cpu = init_weights(make(), torch.Generator().manual_seed(17)).eval()
        gpu = make().cuda().eval()
        gpu.load_state_dict(cpu.state_dict())
        with torch.inference_mode():
            for u, v in zip(cpu(x), gpu(x.cuda())):
                scale = float(u.abs().max())
                torch.testing.assert_close(v.cpu(), u, atol=1e-4 * scale,
                                           rtol=0, msg=name)
        print(f"  {name} (small) f32 2x3x64x64 cuda == cpu within 1e-4 of "
              f"each map's largest magnitude", flush=True)


def run_hrnet_attention_path(torch, sn, hn, card):
    """Phase 11: the `rrnet_hrnetv2_attention` preset at full width
    (HRNetV2-w40, two stacks on its 40- and 80-channel maps, the windowed
    self-attention on each, stage 2 on the 320-channel map, topk 1500,
    512 ROIs, bf16), seeded weights with each `attention{i}.W` drawn
    nonzero from the generator (at its zero init the attention adds 0).
    Serving: `Predictor` answers 16 single 765x1360 requests and a batch
    of 4 in the 768x1408 bucket (p50 / p90), one hard-NMS launch a
    forward; one request's keep mask redone by the plain fixpoint, and
    `select_rois` run under the sync debug mode "error". Then the same
    model with `nms_type_for_stage1=soft_nms`: one B.2 launch a forward
    and one request's ROIs equal to the plain serial soft-NMS's.
    Training: `Trainer` takes 10 steps on one seeded batch of 4 uint8
    512x512 crops (finite, falling totals; step p50, peak memory); the
    HRNetV2 BN statistics bitwise unchanged (`norm_eval`), the attention
    towers' and stage 2's moved; an inf batch leaves the state bitwise.
    Eval: `evaluate_split` at the preset's protocol (six scales,
    auto_test) over 8 frames at batch 4 (images/s, peak memory, one
    hard-NMS launch a scale a batch). Then the small reference, and a
    full-width bf16 eval forward of the dense and the SE hourglass and
    ShuffleNetV2 0.5x at 1x3x768x1408. Each part runs with every launch
    count set to 0 just before it and read just after. Returns (the JSON
    "hrnetv2_attention" entry, {kernel: launches of this path})."""
    import tempfile
    from rrnet_torch import config as cfglib
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_backbone, build_model
    from rrnet_torch.models.rrnet import mask_heatmap_extent
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.ops.heatmap import topk_decode, topk_desc
    from rrnet_torch.profile_train import synthetic_batch
    from rrnet_torch.serving import Predictor
    from rrnet_torch.train import Trainer

    def zero_counts():
        hn.launches = sn.launches = sn.classes_launches = 0
        tdc.fwd_launches = tdc.bwd_launches = 0

    def read_counts():
        return {"hard_nms": hn.launches, "soft_nms": sn.launches,
                "soft_nms_classes": sn.classes_launches,
                "dcn": tdc.fwd_launches + tdc.bwd_launches}

    cfg = cfglib.rrnet_hrnetv2_attention_config()
    entry, launches = {}, {}
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(cfg.seed)
    model = build_model(cfg, device="cpu", generator=gen)
    drawn = draw_attention_w(torch, model.named_parameters(), gen)
    model = model.to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  rrnet_hrnetv2_attention preset: {cfg.model.backbone} widths "
          f"{model.backbone.out_channels}, attention on stacks 0-1, "
          f"{cfg.model.dtype}, topk {cfg.model.topk}, {cfg.model.stage2_rois} "
          f"ROIs, {n_params} params, built in "
          f"{time.perf_counter() - t0:.1f} s; {sorted(drawn)} drawn from the "
          f"generator (seed {cfg.seed}), not zero", flush=True)
    if n_params != 46_582_616:
        raise AssertionError(f"rrnet_hrnetv2_attention has {n_params} params")

    # --- serving at the defaults (hard NMS)
    pred = Predictor(cfg, model, device="cuda")
    forwards = []
    hook = model.register_forward_hook(
        lambda module, args, kwargs, out: forwards.append(
            (out, kwargs.get("valid_hw"))), with_kwargs=True)
    frames = demo_frames(16)
    images = [f["image"] for f in frames]
    pred.warmup(((765, 1360),), batch_sizes=(1, 4))
    torch.cuda.synchronize()
    forwards.clear()
    zero_counts()
    ms, outs = [], []
    for im in images:
        t = time.perf_counter()
        outs.append(pred.predict(im))
        ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    outs += pred.predict_batch(images[:4])
    batch_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    counts = read_counts()                                   # just after
    n_fwd = len(forwards)
    if counts != {"hard_nms": n_fwd, "soft_nms": 0, "soft_nms_classes": 0,
                  "dcn": 0} or n_fwd != len(images) + 1:
        raise AssertionError(f"hrnetv2-attention serving: launches {counts} "
                             f"in {n_fwd} forwards (want one hard_nms each)")
    for d in outs:
        check_detections(d, cfg.model.stage2_rois, cfg.num_classes)
    launches["hard_nms"] = counts["hard_nms"]
    p50, p90 = (float(np.percentile(ms, q)) for q in (50, 90))
    entry["serve"] = {"p50_ms": p50, "p90_ms": p90, "batch4_ms": batch_ms,
                      "requests": len(ms), "hard_nms_launches": n_fwd,
                      "rows": [len(d) for d in outs]}
    print(f"  hrnetv2-attention serving on {card}: {len(ms)} single "
          f"765x1360 requests p50 {p50:.2f} ms, p90 {p90:.2f} ms (min "
          f"{min(ms):.2f}, max {max(ms):.2f}); a batch of 4 {batch_ms:.2f} "
          f"ms; launches {counts} in {n_fwd} forwards; rows per request "
          f"{[len(d) for d in outs[:4]]}...", flush=True)

    def redo(select, name):
        """Request 0's ROI selection again from its own heads with
        `select(dets) -> masked scores`: the same ROIs, classes and
        validity, scores within rtol 1e-5; then `select_rois` on the same
        candidates under the sync debug mode "error"."""
        out, vhw = forwards[0]
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
                raise AssertionError(f"hrnetv2-attention ROI selection "
                                     f"differs from the plain {name}")
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
        return dets, int(out.roi_valid.sum())

    dets, n_rois = redo(lambda d: torch.where(hn.hard_nms_reference(
        d.boxes, d.scores, model.nms_iou, None, d.classes), d.scores,
        -torch.inf), "hard-NMS fixpoint")
    with torch.inference_mode():
        keep = hn.hard_nms(dets.boxes.contiguous(), dets.scores.contiguous(),
                           model.nms_iou, class_ids=dets.classes.contiguous())
        ref = hn.hard_nms_reference(dets.boxes, dets.scores, model.nms_iou,
                                    None, dets.classes)
    if not torch.equal(keep, ref):
        raise AssertionError("hrnetv2-attention request: hard_nms keep "
                             "differs from the plain fixpoint")
    print(f"  request 0: the kernel's keep mask ({int(keep.sum())} of "
          f"{keep.numel()}) bit-equal to the plain fixpoint; ROI selection "
          f"== the plain fixpoint's ({n_rois} ROIs); select_rois ran under "
          f"the sync debug mode \"error\"", flush=True)

    # --- the same model with per-class soft-NMS: B.2
    model.nms_type = "soft_nms"
    forwards.clear()
    zero_counts()
    ms_soft = []
    for im in images[:4]:
        t = time.perf_counter()
        check_detections(pred.predict(im), cfg.model.stage2_rois,
                         cfg.num_classes)
        ms_soft.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    counts = read_counts()                                   # just after
    if counts != {"hard_nms": 0, "soft_nms": 0, "soft_nms_classes": 4,
                  "dcn": 0} or len(forwards) != 4:
        raise AssertionError(f"hrnetv2-attention soft-NMS: launches {counts} "
                             f"in {len(forwards)} forwards (want one "
                             f"soft_nms_classes each)")
    launches["soft_nms_classes"] = counts["soft_nms_classes"]

    def plain_soft(d):
        ns, keep, _ = sn.soft_nms_reference(
            d.boxes, d.scores, None, d.classes, sigma=model.soft_nms_sigma,
            iou_threshold=model.nms_iou,
            score_threshold=model.soft_nms_score_threshold,
            method="gaussian", max_out=model.stage2_rois)
        return torch.where(keep, ns, -torch.inf)

    _, n_rois = redo(plain_soft, "serial soft-NMS")
    model.nms_type = "nms"
    hook.remove()
    entry["serve_soft_nms"] = {"p50_ms": float(np.percentile(ms_soft, 50)),
                               "requests": 4, "soft_nms_classes_launches": 4}
    print(f"  soft-NMS per class: launches {counts} in 4 forwards; request "
          f"0's ROIs == the plain serial soft-NMS's ({n_rois} ROIs); p50 "
          f"{entry['serve_soft_nms']['p50_ms']:.2f} ms", flush=True)
    del pred

    # --- training
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(generator=torch.Generator().manual_seed(
        cfg.seed))
    draw_attention_w(torch, state.params().items(),
                     torch.Generator().manual_seed(cfg.seed + 1))
    batch = synthetic_batch(np.random.RandomState(cfg.seed))
    stats0 = {k: v.clone() for k, v in state.batch_stats().items()}
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    ms, metrics = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    stats = state.batch_stats()
    frozen_moved = [k for k in stats0 if k.startswith("backbone.")
                    and not torch.equal(stats[k], stats0[k])]
    stuck = [k for k in stats0 if not k.startswith("backbone.")
             and torch.equal(stats[k], stats0[k])]
    n_frozen = sum(k.startswith("backbone.") for k in stats0)
    before = state_bits(torch, state)
    bad = dict(batch, images=np.full(batch["images"].shape, np.inf,
                                     np.float32))
    state, m_bad = trainer.train_step(state, bad)
    torch.cuda.synchronize()
    after = state_bits(torch, state)
    counts = read_counts()                                   # just after
    if counts != {"hard_nms": 11, "soft_nms": 0, "soft_nms_classes": 0,
                  "dcn": 0}:
        raise AssertionError(f"hrnetv2-attention train steps launched "
                             f"{counts} (want 11 hard_nms)")
    launches["hard_nms_train"] = counts["hard_nms"]
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"non-finite hrnetv2-attention losses: "
                             f"{metrics}")
    totals = [m["total"] for m in metrics]
    if not totals[-1] < totals[0] or any(m["skipped"] for m in metrics):
        raise AssertionError(f"hrnetv2-attention train total did not fall: "
                             f"{totals}")
    if frozen_moved or stuck:
        raise AssertionError(f"hrnetv2-attention BN statistics: frozen ones "
                             f"moved {frozen_moved[:5]}, others stuck "
                             f"{stuck[:5]}")
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    if float(m_bad["skipped"]) != 1.0 or changed:
        raise AssertionError(f"hrnetv2-attention inf batch: skipped "
                             f"{float(m_bad['skipped'])}, state changed in "
                             f"{changed}")
    timed = ms[2:]
    entry["train"] = {"step_p50_ms": float(np.percentile(timed, 50)),
                      "max_memory_allocated_gib": peak / 2**30,
                      "totals": totals, "step_ms": ms,
                      "frozen_bn_buffers": n_frozen,
                      "moved_bn_buffers": len(stats0) - n_frozen}
    print(f"  hrnetv2-attention train step 4x512x512 {cfg.model.dtype} on "
          f"{card}: p50 {entry['train']['step_p50_ms']:.2f} ms (steps 3-10; "
          f"{[round(x, 1) for x in ms]}); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; (hm, wh, off, s2, total) per step "
          + "; ".join(f"{m['hm']:.4f} {m['wh']:.4f} {m['off']:.4f} "
                      f"{m['s2']:.4f} {m['total']:.4f}" for m in metrics)
          + f"; the {n_frozen} HRNetV2 BN buffers bitwise unchanged, the "
          f"{len(stats0) - n_frozen} others moved; inf batch skipped with "
          "the state bitwise unchanged", flush=True)

    # --- evaluation at the preset's protocol
    model = trainer.model.eval()
    model.load_state_dict(state.state_dict())
    del trainer, state
    ev = Evaluator(cfg, model, device="cuda")
    tmp = tempfile.TemporaryDirectory()
    ev.evaluate_split(frames[:4], result_dir=os.path.join(tmp.name, "w"),
                      verbose=False)
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_dir = ev.evaluate_split(frames[:8], result_dir=os.path.join(
        tmp.name, "hr"), batch_size=4, verbose=False)
    secs = time.perf_counter() - t0
    counts = read_counts()                                   # just after
    peak = torch.cuda.max_memory_allocated()
    n_rows = 0
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            n_rows += len(f.readlines())
    tmp.cleanup()
    n_scales = len(cfg.val.scales)
    if counts != {"hard_nms": 2 * n_scales, "soft_nms": 0,
                  "soft_nms_classes": 0, "dcn": 0} or n_rows == 0:
        raise AssertionError(f"hrnetv2-attention eval: launches {counts} "
                             f"(want {2 * n_scales} hard_nms), {n_rows} rows")
    launches["hard_nms_eval"] = counts["hard_nms"]
    entry["eval"] = {"images_per_s": 8 / secs, "scales": list(cfg.val.scales),
                     "hard_nms_launches": counts["hard_nms"],
                     "max_memory_allocated_gib": peak / 2**30,
                     "rows_written": n_rows}
    print(f"  hrnetv2-attention preset protocol ({n_scales} scales, no flip, "
          f"auto_test), 8 frames 765x1360 at batch 4 on {card}: "
          f"{8 / secs:.2f} images/s ({secs * 1e3:.1f} ms, files written); "
          f"hard_nms launches {counts['hard_nms']} in 2 batches (one a "
          f"scale a batch); max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"{n_rows} rows written", flush=True)
    del model, ev

    check_small_hrnet_attention(torch)

    # --- the rest of the registry at full width, bf16 eval forwards
    x = torch.from_numpy(np.random.RandomState(18).randn(1, 3, 768, 1408)
                         .astype(np.float32)).cuda()
    entry["backbones"] = {}
    for name in ("dense_hourglass", "se_hourglass", "shufflenet_0.5x"):
        bb = build_backbone(name, dtype=torch.bfloat16)
        fwd = []
        with torch.inference_mode():
            outs = bb(x)
            for _ in range(6):
                torch.cuda.synchronize()
                t = time.perf_counter()
                outs = bb(x)
                torch.cuda.synchronize()
                fwd.append((time.perf_counter() - t) * 1e3)
        shapes = [tuple(o.shape) for o in outs]
        if not all(bool(torch.isfinite(o).all()) for o in outs):
            raise AssertionError(f"{name}: non-finite maps")
        entry["backbones"][name] = {
            "forward_p50_ms": float(np.percentile(fwd[1:], 50)),
            "params": sum(p.numel() for p in bb.parameters()),
            "shapes": shapes}
        print(f"  {name} full width bf16 1x3x768x1408 on {card}: forward p50 "
              f"{entry['backbones'][name]['forward_p50_ms']:.2f} ms, "
              f"{entry['backbones'][name]['params']} params, maps {shapes}",
              flush=True)
        del bb, outs
    entry["launches"] = launches
    return entry, launches


# the 768x1408 bucket's quantized convs on the main path (hourglass-104 at
# stride 4 and its downsampled levels, and stage 2's FasterRCNNHead on the
# 3x3 ROI features): (label, cin, cout, kernel, stride, h, w, bias)
INT8_HOURGLASS_SHAPES = [
    ("pre_res 3x3 s2 128->256", 128, 256, 3, 2, 384, 704, False),
    ("3x3 s1 256", 256, 256, 3, 1, 192, 352, False),
    ("3x3 s2 256->256", 256, 256, 3, 2, 192, 352, False),
    ("3x3 s2 256->384", 256, 384, 3, 2, 96, 176, False),
    ("3x3 s1 384", 384, 384, 3, 1, 48, 88, False),
    ("3x3 s2 384->512", 384, 512, 3, 2, 12, 22, False),
    ("3x3 s1 512", 512, 512, 3, 1, 6, 11, False),
    ("1x1 s2 skip 256->384", 256, 384, 1, 2, 96, 176, False),
    ("1x1 s1 skip 512->384", 512, 384, 1, 1, 6, 11, True),
]
INT8_ROI_SHAPES = [
    ("roi conv1 1x1 256->64", 256, 64, 1, 1, 3, 3, False),
    ("roi conv2 3x3 64", 64, 64, 3, 1, 3, 3, False),
    ("roi conv3 1x1 64->256", 64, 256, 1, 1, 3, 3, False),
    ("roi downsample 1x1 256", 256, 256, 1, 1, 3, 3, False),
]
INT8_OPS_PER_S = 1979e12        # tensor cores, int8 dense
# f32 operations a value of the quantize pass: multiply, round, 2 clamps
QUANTIZE_OPS_PER_VALUE = 4


def before_int8(torch, src):
    """`int8_conv2d(xq, pw, s_in, bias, stride, pad4, out_dtype)` on the
    int8 convolution built from the int8_conv.cu in `src` (the earlier
    design, `git show 5cd1773:rrnet_torch/csrc/int8_conv.cu`: mma.sync
    with split-K decided in C) into src/build, with this checkout's
    checks, scale, bias and allocations around the launch, so that the
    two versions are timed on equal terms. It counts no launch."""
    import ctypes
    from pathlib import Path
    from rrnet_torch.ops import int8_conv as ic
    from rrnet_torch.utils import native
    src = Path(src)
    lib = ctypes.CDLL(str(native.build_all(("int8_conv",), src,
                                           src / "build")["int8_conv"]))
    conv = lib.rrnet_int8_conv
    conv.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p]
    conv.restype = ctypes.c_int
    splits = lib.rrnet_int8_conv_splits
    splits.argtypes = [ctypes.c_int] * 5
    splits.restype = ctypes.c_int

    def run(xq, pw, s_in, bias, stride, pad4, out_dtype):
        sh, sw, ho, wo = ic.conv_geometry(xq, pw, stride, pad4)
        cout, _, kh, kw = pw.wq.shape
        n, h, wd, cp = xq.shape
        kp = pw.rows.shape[1]
        i32 = out_dtype == torch.int32
        scale = None if i32 else ic.dequant_scale(pw.s_w, s_in)
        if bias is not None and not i32:
            bias = bias.to(out_dtype).contiguous()
        else:
            bias = None
        split = splits(n, ho, wo, cout, kp) == 1
        shape = (n, cout, ho, wo)
        out = (torch.zeros if split and i32 else torch.empty)(
            shape, dtype=out_dtype, device=xq.device)
        acc = (torch.zeros(shape, dtype=torch.int32, device=xq.device)
               if split and not i32 else None)
        err = conv(xq.data_ptr(), pw.rows.data_ptr(),
                   None if scale is None else scale.data_ptr(),
                   None if bias is None else bias.data_ptr(),
                   out.data_ptr(), None if acc is None else acc.data_ptr(),
                   {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}[
                       out_dtype], n, h, wd, cp, cout, kh, kw, sh, sw,
                   pad4[0], pad4[2], ho, wo, kp,
                   torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{src}: int8 conv launch failed: {err}")
        return out
    return run


def int8_device_ms(torch, fn, reps=5):
    """Device ms a call of `fn` spends in int8 conv kernels (the split-K
    epilogue included), by the profiler."""
    return sum(v for key, v in device_split(torch, fn, reps).items()
               if "int8_conv" in key or "dequant_kernel" in key)


def check_int8_conv(torch, rng, card, before=None):
    """The int8 kernels against their plain versions on the card at the
    main path's shapes (bf16 in, bf16 out; batch 1 and 4 of the 768x1408
    bucket, and stage 2 on 4x512 ROIs): quantize_pack's NHWC int8, the
    conv's int32 accumulators and its dequantized bf16 output (and f32
    with a bias, once) bit-equal; each timed beside its bound, its plain
    version, cuDNN's bf16 convolution of the same shape (the conv the
    int8 path replaces) and, for 1x1 stride-1 shapes, `torch._int_mm` on
    the NHWC matrix (a yardstick only: the port never calls it). With
    `before` (`before_int8`'s launcher of another version) each shape's
    device ms of both versions, in turns (before, after, after, before),
    and that version bit-equal too. Returns the kernels' two lines."""
    import torch.nn.functional as F
    from rrnet_torch.ops import int8_conv as ic
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(int(rng.randint(1 << 30)))
    cases = ([(n,) + s for s in INT8_HOURGLASS_SHAPES for n in (1, 4)]
             + [(4 * 512,) + s for s in INT8_ROI_SHAPES])
    rows = []
    for n, label, cin, cout, k, stride, h, w, with_bias in cases:
        x = torch.relu(torch.randn(n, cin, h, w, device=dev, generator=g)
                       ).to(torch.bfloat16)
        weight = torch.randn(cout, cin, k, k, device=dev,
                             generator=g) / (k * k * cin) ** 0.5
        bias = (torch.randn(cout, device=dev, generator=g) * 0.1
                if with_bias else None)
        absmax = float(x.abs().amax())
        s_in = absmax / 127.0
        pad = (k - 1) // 2
        pad4 = (pad,) * 4
        pw = ic.pack_weight(weight)
        xq = ic.quantize_pack(x, absmax)
        acc = ic.int8_conv2d(xq, pw, s_in, None, stride, pad4, torch.int32)
        y = ic.int8_conv2d(xq, pw, s_in, bias, stride, pad4, torch.bfloat16)
        torch.cuda.synchronize()
        xq_ref = ic.quantize_pack_plain(x, absmax)
        acc_ref = ic.int8_conv2d_plain(xq_ref, pw.wq, pw.s_w, s_in, None,
                                       stride, pad4, torch.int32)
        y_ref = ic.int8_conv2d_plain(xq_ref, pw.wq, pw.s_w, s_in, bias,
                                     stride, pad4, torch.bfloat16)
        same = (torch.equal(xq, xq_ref), torch.equal(acc, acc_ref),
                torch.equal(y, y_ref))
        err = float((y.float() - y_ref.float()).abs().max())
        if with_bias:
            y32 = ic.int8_conv2d(xq, pw, s_in, bias, stride, pad4,
                                 torch.float32)
            same += (torch.equal(y32, ic.int8_conv2d_plain(
                xq_ref, pw.wq, pw.s_w, s_in, bias, stride, pad4,
                torch.float32)),)
        if not all(same):
            raise AssertionError(
                f"int8 kernels differ from their plain versions ({label}, "
                f"batch {n}): int8 NHWC, int32, bf16 (, f32) equal {same}, "
                f"largest gap {err:.3g}")
        ms = cuda_ms(lambda: ic.int8_conv2d(xq, pw, s_in, bias, stride, pad4,
                                            torch.bfloat16), reps=20)
        turns = None
        if before is not None:
            if not torch.equal(before(xq, pw, s_in, bias, stride, pad4,
                                      torch.bfloat16), y):
                raise AssertionError(f"int8 {label} batch {n}: the --before "
                                     "build differs from this one")
            fns = {"before": lambda: before(xq, pw, s_in, bias, stride, pad4,
                                            torch.bfloat16),
                   "after": lambda: ic.int8_conv2d(xq, pw, s_in, bias, stride,
                                                   pad4, torch.bfloat16)}
            turns = {"before": [], "after": []}
            for which in ("before", "after", "after", "before"):
                turns[which].append(int8_device_ms(torch, fns[which]))
            print(f"  int8 before/after {label} batch {n} on {card}: device "
                  f"ms before {turns['before'][0]:.4f}, "
                  f"{turns['before'][1]:.4f}; after {turns['after'][0]:.4f}, "
                  f"{turns['after'][1]:.4f}", flush=True)
        pack_ms = cuda_ms(lambda: ic.quantize_pack(x, absmax), reps=20)
        plain_ms = cuda_ms(lambda: ic.int8_conv2d_plain(
            xq_ref, pw.wq, pw.s_w, s_in, bias, stride, pad4,
            torch.bfloat16), reps=2, warm=1)
        pack_plain_ms = cuda_ms(lambda: ic.quantize_pack_plain(x, absmax),
                                reps=5, warm=1)
        split = device_split(torch, lambda: ic.int8_conv2d(
            ic.quantize_pack(x, absmax), pw, s_in, bias, stride, pad4,
            torch.bfloat16), reps=5)
        dev_ms = sum(v for key, v in split.items()
                     if "int8_conv" in key or "dequant_kernel" in key)
        pack_dev_ms = sum(v for key, v in split.items()
                          if "quantize_pack" in key)
        wb = weight.to(torch.bfloat16)
        bb = None if bias is None else bias.to(torch.bfloat16)
        cudnn_ms = cuda_ms(lambda: F.conv2d(x, wb, bb, stride, pad), reps=20)
        int_mm_ms = int_mm_note = None
        if k == 1 and stride == 1:
            a = xq.view(-1, xq.shape[-1])
            b = pw.rows[:, :xq.shape[-1]].t()
            try:
                mm = torch._int_mm(a, b)
                torch.cuda.synchronize()
                int_mm_note = ("equal" if torch.equal(
                    mm, acc.permute(0, 2, 3, 1).reshape(-1, cout))
                    else "differs")
                int_mm_ms = cuda_ms(lambda: torch._int_mm(a, b), reps=20)
            except RuntimeError as e:
                int_mm_note = f"refused: {str(e).splitlines()[0][:120]}"
        ho, wo = acc.shape[-2:]
        m = n * ho * wo
        ops = 2.0 * m * cout * k * k * cin
        nbytes = n * h * w * cin + cout * k * k * cin + m * cout * 2 + 4 * cout
        bound_ops = ops / INT8_OPS_PER_S * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        p_bytes = n * cin * h * w * 2 + n * h * w * xq.shape[-1]
        p_bound_bytes = p_bytes / HBM_BYTES_PER_S * 1e3
        p_bound_ops = (n * cin * h * w * QUANTIZE_OPS_PER_VALUE
                       / F32_FLOPS_PER_S * 1e3)
        row = {"shape": label, "batch": n, "in": [n, cin, h, w],
               "out": [n, cout, int(ho), int(wo)], "ms": ms,
               "device_ms": dev_ms, "pack_device_ms": pack_dev_ms,
               "plain_ms": plain_ms, "bound_ms": max(bound_ops, bound_bytes),
               "bound_by": ("operations" if bound_ops >= bound_bytes
                            else "bytes"),
               "cudnn_bf16_ms": cudnn_ms, "int_mm_ms": int_mm_ms,
               "int_mm": int_mm_note, "tops": ops / ms / 1e9,
               "pack_ms": pack_ms, "pack_plain_ms": pack_plain_ms,
               "pack_bound_ms": max(p_bound_bytes, p_bound_ops),
               "pack_bound_by": ("bytes" if p_bound_bytes >= p_bound_ops
                                 else "operations"),
               "before_after_device_ms": turns}
        rows.append(row)
        print(f"  int8 {label} batch {n} ({'x'.join(map(str, row['in']))} "
              f"-> {'x'.join(map(str, row['out']))}) on {card}: int8 NHWC, "
              f"int32 accumulators and bf16 output"
              + (" (and f32 + bias)" if with_bias else "")
              + f" bit-equal to the plain versions; conv {ms:.4f} ms "
              f"(device {dev_ms:.4f}; {row['tops']:.1f} TOPS), bound "
              f"{row['bound_ms']:.4f} "
              f"({row['bound_by']}), cuDNN bf16 {cudnn_ms:.4f}, plain "
              f"{plain_ms:.3f}"
              + (f", torch._int_mm {int_mm_ms:.4f} ({int_mm_note})"
                 if int_mm_ms is not None else
                 (f", torch._int_mm {int_mm_note}" if int_mm_note else ""))
              + f"; quantize_pack {pack_ms:.4f} ms (device "
              f"{pack_dev_ms:.4f}), bound "
              f"{row['pack_bound_ms']:.4f}, plain {pack_plain_ms:.4f}",
              flush=True)
        del x, xq, xq_ref, acc, acc_ref, y, y_ref
    main = next(r for r in rows if r["shape"] == "3x3 s1 256"
                and r["batch"] == 1)
    total = {key: sum(r[key] for r in rows if r["batch"] == 1)
             for key in ("ms", "device_ms", "bound_ms", "cudnn_bf16_ms",
                         "pack_ms", "pack_device_ms")}
    print(f"  int8 totals over the {sum(r['batch'] == 1 for r in rows)} "
          f"batch-1 hourglass shapes on {card}: conv {total['ms']:.4f} ms "
          f"(device {total['device_ms']:.4f}) against cuDNN bf16 "
          f"{total['cudnn_bf16_ms']:.4f}, bound {total['bound_ms']:.4f}; "
          f"quantize_pack {total['pack_ms']:.4f} (device "
          f"{total['pack_device_ms']:.4f})", flush=True)
    conv = {"name": "int8_conv2d", "route": "cuda",
            "design": "wgmma m64n128k32 s8, both operands from shared "
                      "memory; weights by TMA (2-D tiled, 128-byte "
                      "swizzle), activations by a cp.async producer "
                      "warpgroup; warp-specialised persistent grid, "
                      "4-stage mbarrier ring; split-K by int32 atomics",
            "source": "rrnet_torch/csrc/int8_conv.cu",
            "replaces": "rrnet_tpu/models/layers.py:166 (not a TPU kernel: "
                        "XLA's int8 conv_general_dilated)",
            "launches": None, "max_abs_err": 0.0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["cudnn_bf16_ms"],
            "device_ms": main["device_ms"],
            "at": "3x3 s1 256 at 1x256x192x352, bf16 out; library_ms is "
                  "cuDNN's bf16 F.conv2d",
            "shapes": rows}
    pack = {"name": "int8_quantize_pack", "route": "cuda",
            "source": "rrnet_torch/csrc/int8_conv.cu",
            "replaces": "rrnet_tpu/models/layers.py:155 (not a TPU kernel: "
                        "XLA's fused quantize)",
            "launches": None, "max_abs_err": 0.0, "ms": main["pack_ms"],
            "plain_ms": main["pack_plain_ms"],
            "bound_ms": main["pack_bound_ms"],
            "bound_by": main["pack_bound_by"], "library_ms": None,
            "device_ms": main["pack_device_ms"],
            "at": "1x256x192x352 bf16 -> NHWC int8; no one PyTorch call "
                  "quantizes and transposes"}
    return conv, pack


# (label, N, C, H, W, epilogue): the eval cells' conv outputs at scale 1.5
# of the 768x1408 bucket (stride 4: 288x544), batch 4, bf16
CONV_EPILOGUE_SHAPES = [
    ("hourglass conv1: bias, relu", 4, 256, 288, 544, "relu"),
    ("hourglass conv2: bias, + x, relu", 4, 256, 288, 544, "residual"),
    ("hourglass 384-ch conv2 at stride 8: bias, + x, relu", 4, 384, 144,
     272, "residual"),
    ("HRNet branch 0 conv2: bias, + x, relu", 4, 40, 288, 544, "residual"),
    ("a 10-ch conv, bias alone (the scalar path)", 4, 10, 288, 544, "bias"),
]
# the eval convs of one forward of the rrnet preset that finish with a
# bias, a residual or a ReLU: its 163 folded conv-BN pairs and the 6 biased
# towers of its two stacks' three heads (the `conv_epilogue.plain` count of
# one forward on the CPU)
RRNET_EPILOGUES_PER_FORWARD = 169


def check_conv_epilogue(torch, card):
    """`csrc/conv_epilogue.cu` against its plain version at the eval
    cells' main shapes (`CONV_EPILOGUE_SHAPES`), bit-equal, then timed
    beside its byte bound at 3.35 TB/s (y read and written, the residual
    read once) and the plain version's time. Returns the kernels line."""
    from rrnet_torch.ops import conv_epilogue as ce
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    rows = []
    for label, n, c, h, w, kind in CONV_EPILOGUE_SHAPES:
        def draw(*shape):
            return torch.randn(*shape, device=dev, generator=g).to(
                torch.bfloat16)
        y = draw(n, c, h, w).contiguous(memory_format=torch.channels_last)
        b = draw(c)
        r = (None if kind in ("relu", "bias") else
             draw(n, c, h, w).contiguous(memory_format=torch.channels_last))
        relu = kind != "bias"
        want = ce.conv_epilogue_reference(y, b, r, relu)
        got = ce.conv_epilogue(y.clone(), b, r, relu)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"conv_epilogue differs from its plain "
                                 f"version at {label}")
        del got, want
        ms = cuda_ms(lambda: ce.conv_epilogue(y, b, r, relu), 20)
        plain_ms = cuda_ms(
            lambda: ce.conv_epilogue_reference(y, b, r, relu), 5)
        nbytes = y.numel() * 2 * (2 if r is None else 3)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"at": label, "shape": [n, c, h, w], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_share": bound_ms / ms,
               "tb_per_s": nbytes / ms / 1e9}
        rows.append(row)
        print(f"  conv_epilogue {label} {n}x{c}x{h}x{w} bf16 on {card}: "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms), byte bound "
              f"{bound_ms:.4f} ms at 3.35 TB/s: {100 * bound_ms / ms:.1f}% "
              f"({nbytes / ms / 1e9:.3f} TB/s); bit-equal", flush=True)
        del y, r
    main = rows[0]
    return {"name": "conv_epilogue", "route": "cuda",
            "design": "in place on the channels-last conv output: 16-byte "
                      "vectors (8 bf16 channels), 4 a thread loaded before "
                      "any is stored, bias vectors from L1; a scalar path "
                      "where C % 8 != 0",
            "source": "rrnet_torch/csrc/conv_epilogue.cu",
            "replaces": "not a TPU kernel: XLA fused the conv's BN affine, "
                        "residual add and ReLU into its convolution",
            "launches": None, "max_abs_err": 0.0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "at": f"{main['at']} at 4x256x288x544 bf16; no one PyTorch call "
                  "adds a bias, a residual and takes the ReLU",
            "shapes": rows}


def int8_counts(torch):
    """The launch counts of every kernel wrapper, the int8 pair included."""
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.ops import hard_nms as hn
    from rrnet_torch.ops import int8_conv as ic
    from rrnet_torch.ops import soft_nms as sn
    return {"hard_nms": hn.launches, "soft_nms": sn.launches,
            "soft_nms_classes": sn.classes_launches,
            "dcn": tdc.fwd_launches + tdc.bwd_launches,
            "int8_conv2d": ic.launches, "int8_quantize_pack": ic.pack_launches}


def zero_int8_counts():
    from rrnet_torch.ops import deform_conv as tdc
    from rrnet_torch.ops import hard_nms as hn
    from rrnet_torch.ops import int8_conv as ic
    from rrnet_torch.ops import soft_nms as sn
    hn.launches = sn.launches = sn.classes_launches = 0
    tdc.fwd_launches = tdc.bwd_launches = 0
    ic.launches = ic.pack_launches = 0


def detection_agreement(preds, preds8):
    """The share of bf16's strong detections (score > 0.3, or the top 50
    where none is) with an int8 detection of the same class whose centre
    lies within 3 px (scripts/bench_int8.py's measure); (share, count)."""
    agree = total = 0
    for p, q in zip(preds, preds8):
        a = p[p[:, 4] > 0.3]
        if len(a) == 0:
            a = p[:50]
        total += len(a)
        for row in a:
            c = row[:2] + row[2:4] / 2
            d = np.linalg.norm(q[:, :2] + q[:, 2:4] / 2 - c, axis=1)
            j = int(np.argmin(d)) if len(d) else -1
            if j >= 0 and d[j] < 3.0 and q[j, 5] == row[5]:
                agree += 1
    return agree / max(total, 1), total


def int8_forward_split(torch, pred, image):
    """One int8 request's device time by the profiler: the int8 convs
    (with their split-K epilogues), the quantize passes and all kernels,
    ms a forward; beside the summed bounds of the 162 convs and quantize
    passes at the shapes a forward hook records."""
    from rrnet_torch.models.layers import Conv2d
    shapes = []
    model = pred._ev.model
    hooks = [m.register_forward_hook(
        lambda m, a, out: shapes.append((tuple(a[0].shape),
                                         tuple(m.weight.shape),
                                         tuple(out.shape))))
             for m in model.modules() if isinstance(m, Conv2d)
             and m.quantizable and m.groups == 1]
    with torch.inference_mode():
        pred.predict(image)
    for h in hooks:
        h.remove()
    split = device_split(torch, lambda: pred.predict(image), reps=3)
    conv_bound = pack_bound = 0.0
    for (n, cin, h, w), (cout, _, kh, kw), (_, _, ho, wo) in shapes:
        if cin < 32:
            continue
        ops = 2.0 * n * ho * wo * cout * kh * kw * cin
        nbytes = n * h * w * cin + cout * kh * kw * cin + n * ho * wo * cout * 2
        conv_bound += max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
        pack_bound += max(n * cin * h * w * 3 / HBM_BYTES_PER_S,
                          n * cin * h * w * QUANTIZE_OPS_PER_VALUE
                          / F32_FLOPS_PER_S)
    return {"conv_ms": sum(v for k, v in split.items()
                           if "int8_conv" in k or "dequant_kernel" in k),
            "pack_ms": sum(v for k, v in split.items()
                           if "quantize_pack" in k),
            "all_kernels_ms": sum(split.values()),
            "conv_bound_ms": conv_bound * 1e3,
            "pack_bound_ms": pack_bound * 1e3,
            "convs": sum(s[0][1] >= 32 for s in shapes)}


def serve_times(pred, imgs, passes=2):
    """Host ms of each single request, `passes` times over `imgs`, and the
    detections."""
    ms, outs = [], []
    for _ in range(passes):
        for im in imgs:
            t0 = time.perf_counter()
            outs.append(pred.predict(im))
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms, outs


def run_int8_path(torch, card, before=None):
    """Phase "int8 path": the `rrnet` preset at full width (bf16, seeded
    weights) served through `Predictor(quantize="int8")` beside the bf16
    `Predictor` on the same model: warmup refused before calibration, the
    calibration on 4 demo frames (162 convs, the JAX package's count),
    16 requests each (p50 / p90; the int8 run's launches a forward: 162
    int8 convs, 162 quantize passes, one hard_nms), the detection
    agreement with bf16; then `evaluate_split` at the preset's six-scale
    protocol over 8 frames at batch 4, int8 against bf16 (images/s, peak
    memory, launches); and the calibrated conv counts of the `centernet`
    and `retinanet` presets at full width on a 128x128 frame. Returns the
    JSON entry."""
    import dataclasses
    import tempfile
    from rrnet_torch import config as cfglib
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_model
    from rrnet_torch.serving import Predictor

    entry = {}
    cfg = cfglib.rrnet_config()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    frames = demo_frames(8)
    imgs = [f["image"] for f in frames]
    bf = Predictor(cfg, model, device="cuda")
    i8 = Predictor(cfg, model, device="cuda", quantize="int8")
    try:
        i8.warmup()
    except RuntimeError:
        pass
    else:
        raise AssertionError("an uncalibrated int8 Predictor warmed up")
    t0 = time.perf_counter()
    scales = i8.calibrate(imgs[:4])
    calib_s = time.perf_counter() - t0
    if len(scales) != 162:
        raise AssertionError(f"rrnet int8 calibrated {len(scales)} convs "
                             "(the JAX package: 162)")
    bf.warmup()
    i8.warmup()
    bf_ms, bf_out = serve_times(bf, imgs)
    torch.cuda.synchronize()
    zero_int8_counts()                                   # just before
    i8_ms, i8_out = serve_times(i8, imgs)
    torch.cuda.synchronize()
    counts = int8_counts(torch)                          # just after
    want = {"hard_nms": 16, "soft_nms": 0, "soft_nms_classes": 0, "dcn": 0,
            "int8_conv2d": 162 * 16, "int8_quantize_pack": 162 * 16}
    if counts != want:
        raise AssertionError(f"int8 serving launched {counts} in 16 "
                             f"forwards (want {want})")
    for d in i8_out:
        check_detections(d, cfg.model.stage2_rois, cfg.num_classes)
    agree, compared = detection_agreement(bf_out[:8], i8_out[:8])
    per_forward = int8_forward_split(torch, i8, imgs[0])
    if before is not None:
        # the same requests with the other version's conv (`before_int8`'s
        # launcher, which counts no launch) in turns
        from rrnet_torch.ops import int8_conv as ic
        kernel_conv = ic.int8_conv2d

        def other(xq, w, s_in, bias=None, stride=1, pad4=(0, 0, 0, 0),
                  out_dtype=torch.bfloat16, **kw):
            return before(xq, w, s_in, bias, stride, pad4, out_dtype)
        turns = {"before": [], "after": []}
        for which in ("before", "after", "after", "before"):
            ic.int8_conv2d = other if which == "before" else kernel_conv
            try:
                ms = serve_times(i8, imgs, passes=2)[0]
                split = int8_forward_split(torch, i8, imgs[0])
            finally:
                ic.int8_conv2d = kernel_conv
            turns[which].append({"p50_ms": float(np.percentile(ms, 50)),
                                 "conv_ms": split["conv_ms"],
                                 "all_kernels_ms": split["all_kernels_ms"]})
        entry["before_after_forward"] = turns
        print(f"  int8 before/after forward on {card} (16 requests a turn; "
              "before, after, after, before): " + "; ".join(
                  f"{w} p50 {t['p50_ms']:.2f} ms, int8 convs "
                  f"{t['conv_ms']:.4f} ms, all kernels "
                  f"{t['all_kernels_ms']:.4f}"
                  for w in ("before", "after") for t in turns[w]),
              flush=True)
    entry["serve"] = {
        "calibrated_convs": len(scales), "calibrate_s": calib_s,
        "bf16_p50_ms": float(np.percentile(bf_ms, 50)),
        "bf16_p90_ms": float(np.percentile(bf_ms, 90)),
        "int8_p50_ms": float(np.percentile(i8_ms, 50)),
        "int8_p90_ms": float(np.percentile(i8_ms, 90)),
        "launches": counts, "launches_per_forward": {
            k: v / 16 for k, v in counts.items()},
        "detection_agreement": agree, "detections_compared": compared,
        "per_forward": per_forward, "bf16_ms": bf_ms, "int8_ms": i8_ms}
    s = entry["serve"]
    print(f"  rrnet int8: warmup refused before calibration; calibrated "
          f"{len(scales)} convs on 4 demo frames in {calib_s:.2f} s (the "
          f"JAX package: 162); 16 requests on {card}: int8 p50 "
          f"{s['int8_p50_ms']:.2f} ms, p90 {s['int8_p90_ms']:.2f}; bf16 "
          f"p50 {s['bf16_p50_ms']:.2f}, p90 {s['bf16_p90_ms']:.2f}; int8 "
          f"launches {counts} (a forward: 162 int8 convs, 162 quantize "
          f"passes, 1 hard_nms); detection agreement with bf16 "
          f"{agree:.4f} over {compared} detections; a forward's device "
          f"time (profiler): int8 convs {per_forward['conv_ms']:.4f} ms "
          f"against their bound {per_forward['conv_bound_ms']:.4f}, "
          f"quantize passes {per_forward['pack_ms']:.4f} against "
          f"{per_forward['pack_bound_ms']:.4f}; all kernels "
          f"{per_forward['all_kernels_ms']:.4f} ms", flush=True)

    # the preset's six-scale protocol, bf16 then int8, same weights
    tmp = tempfile.TemporaryDirectory()
    ev = Evaluator(cfg, model, device="cuda")
    ev8 = Evaluator(cfg, model, device="cuda", quantize="int8")
    t0 = time.perf_counter()
    n_six = len(ev8.calibrate(imgs[:4]))
    calib6_s = time.perf_counter() - t0
    n_scales = len(cfg.val.scales)
    for label, e in (("bf16", ev), ("int8", ev8)):
        out_dir = os.path.join(tmp.name, label)
        e.evaluate_split(frames[:4], result_dir=out_dir, verbose=False)
        torch.cuda.synchronize()
        zero_int8_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        e.evaluate_split(frames, result_dir=out_dir, batch_size=4,
                         verbose=False)
        secs = time.perf_counter() - t0
        counts = int8_counts(torch)
        peak = torch.cuda.max_memory_allocated()
        n_q = 162 * n_scales * 2 if label == "int8" else 0
        want = {"hard_nms": n_scales * 2, "soft_nms": 0,
                "soft_nms_classes": 0, "dcn": 0, "int8_conv2d": n_q,
                "int8_quantize_pack": n_q}
        if counts != want:
            raise AssertionError(f"{label} six-scale eval launched {counts} "
                                 f"(want {want})")
        entry[f"six_scales_{label}"] = {
            "images_per_s": 8 / secs, "max_memory_allocated_gib":
            peak / 2**30, "launches": counts}
        print(f"  rrnet {label}, six scales, 8 frames 765x1360 at batch 4 on "
              f"{card}: {8 / secs:.2f} images/s, max_memory_allocated "
              f"{peak / 2**30:.2f} GiB, launches {counts}", flush=True)
    entry["six_scales_int8"]["calibrated_convs"] = n_six
    entry["six_scales_int8"]["calibrate_s"] = calib6_s
    tmp.cleanup()
    del ev, ev8, bf, i8, model

    # the other presets' calibrated counts at full width, a 128x128 frame
    small = (np.random.RandomState(3).rand(128, 128, 3) * 255
             ).astype(np.uint8)
    entry["other_presets"] = {}
    for name, jax_count in (("centernet", 159), ("retinanet", 57)):
        c = cfglib.PRESETS[name]()
        c = c.replace(val=dataclasses.replace(c.val, scales=(1.0,),
                                              flip_tta=False))
        e = Evaluator(c, build_model(c, device="cuda"), device="cuda",
                      quantize="int8")
        n_conv = len(e.calibrate([small]))
        entry["other_presets"][name] = {"calibrated_convs": n_conv,
                                        "jax_package": jax_count}
        print(f"  {name} int8 at full width, one 128x128 frame: calibrated "
              f"{n_conv} convs (the JAX package: {jax_count})", flush=True)
        if n_conv != jax_count:
            raise AssertionError(f"{name}: {n_conv} calibrated convs, the "
                                 f"JAX package {jax_count}")
        del e
    entry["geometries_checked"] = check_int8_geometries(torch, card)
    return entry


def check_int8_geometries(torch, card):
    """One int8 forward of each of the `rrnet`, `centernet` and
    `retinanet` presets at full width (bf16, seeded weights, calibrated on
    one demo frame, scale 1, no flip) on a 765x1360 demo frame, with a hook
    on `int8_conv2d`: the first call of each distinct geometry (input
    shape, weight shape, stride, per-side padding, output dtype, bias or
    not) is redone by the plain version on that call's own inputs and must
    be bit-equal. Returns {preset: geometries checked}."""
    import dataclasses
    from rrnet_torch import config as cfglib
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_model
    from rrnet_torch.ops import int8_conv as ic
    frame = demo_frames(1)[0]["image"]
    orig = ic.int8_conv2d
    seen = {}
    differ = []

    def hooked(xq, w, s_in, bias=None, stride=1, pad4=(0, 0, 0, 0),
               out_dtype=torch.bfloat16, **kw):
        out = orig(xq, w, s_in, bias, stride, pad4, out_dtype, **kw)
        key = (tuple(xq.shape), tuple(w.wq.shape), ic._pair(stride),
               tuple(pad4), out_dtype, bias is not None)
        if key not in seen:
            seen[key] = preset
            if not torch.equal(out, ic.int8_conv2d_plain(
                    xq, w.wq, w.s_w, s_in, bias, stride, pad4, out_dtype)):
                differ.append(key)
        return out

    counts = {}
    ic.int8_conv2d = hooked
    try:
        for preset in ("rrnet", "centernet", "retinanet"):
            c = cfglib.PRESETS[preset]()
            c = c.replace(val=dataclasses.replace(c.val, scales=(1.0,),
                                                  flip_tta=False))
            e = Evaluator(c, build_model(
                c, device="cuda",
                generator=torch.Generator().manual_seed(c.seed)),
                device="cuda", quantize="int8")
            e.calibrate([frame])
            before = len(seen)
            dets = e.predict(frame)
            if dets.ndim != 2 or dets.shape[1] != 6 or not np.isfinite(
                    dets).all():
                raise AssertionError(f"{preset} int8: detections "
                                     f"{dets.shape}, finite "
                                     f"{np.isfinite(dets).all()}")
            counts[preset] = len(seen) - before
            del e
    finally:
        ic.int8_conv2d = orig
    if differ:
        raise AssertionError(f"int8_conv2d differs from its plain version "
                             f"at {len(differ)} of {len(seen)} geometries: "
                             f"{differ[:4]}")
    print(f"  int8 geometries on {card}: one int8 forward each of rrnet, "
          f"centernet and retinanet at full width on a 765x1360 frame; "
          f"{len(seen)} distinct conv geometries ({counts} new in turn), "
          "each call bit-equal to the plain version on its own inputs",
          flush=True)
    return counts


def run_microbatching(torch, card):
    """Phase "micro-batching": a `MicroBatcher` at its defaults (max_batch
    8, max_delay_ms 4, pipeline_depth 2) over the bf16 `rrnet` Predictor
    (full width, seeded weights): 32 requests from 4 client threads at
    once, and a closed loop of 16 beside 16 single `predict` calls; each
    with requests/s, per-request p50 / p90 (submit to result) and the
    histogram of batch sizes. Every future's rows are held bit-equal to
    its frame's rows in `predict_batch` of a group the batcher formed
    (the closed loop's groups are single requests, so there bit-equal to
    `predict`), and the share of its rows that match the frame's single
    request (`match_rows`, 1e-2 px and 1e-4) is reported: a bf16 batch
    differs from B=1 in a few percent of the rows. Then 8 requests from
    4 threads with per-class soft-NMS: B.2 launched once a batch, and one
    batch's ROIs equal to the plain serial soft-NMS's. Returns the JSON
    entry."""
    import threading
    from collections import Counter
    from rrnet_torch import config as cfglib
    from rrnet_torch.models import build_model
    from rrnet_torch.models.rrnet import mask_heatmap_extent
    from rrnet_torch.ops import soft_nms as sn
    from rrnet_torch.ops.heatmap import topk_decode, topk_desc
    from rrnet_torch.serving import MicroBatcher, Predictor

    cfg = cfglib.rrnet_config()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    pred = Predictor(cfg, model, device="cuda")
    pred.warmup(batch_sizes=(1, 2, 4, 8))
    imgs = [f["image"] for f in demo_frames(8)]
    single_ms, singles = serve_times(pred, imgs)
    singles = singles[:8]
    entry = {"single_p50_ms": float(np.percentile(single_ms, 50)),
             "single_p90_ms": float(np.percentile(single_ms, 90)),
             "single_requests_per_s": 1e3 / float(np.mean(single_ms))}

    groups = []                 # the image lists the batcher staged
    stage = pred.stage

    def recording_stage(images):
        groups.append(list(images))
        return stage(images)

    pred.stage = recording_stage

    def hold(results, label):
        """Each future's rows bit-equal to its frame's rows in a
        predict_batch of one of the staged groups; (least, mean) share of
        its rows matching the frame's single request."""
        batched = [(g, pred.predict_batch(g)) for g in groups]
        shares = []
        for i, got in results:
            cands = [rows for g, outs in batched
                     for im, rows in zip(g, outs) if im is imgs[i]]
            if not any(r.shape == got.shape and np.array_equal(r, got)
                       for r in cands):
                raise AssertionError(f"micro-batching {label}: a future's "
                                     f"rows for frame {i} equal no "
                                     f"predict_batch of its groups")
            _, _, _, matched = match_rows(got, singles[i], 1e-2, 1e-4)
            shares.append(matched / max(len(got), len(singles[i]), 1))
        groups.clear()
        return min(shares), float(np.mean(shares))

    def run_clients(n_threads, per_thread):
        mb = MicroBatcher(pred)
        lat, results = [], []
        lock = threading.Lock()

        def client(t):
            futs = []
            for j in range(per_thread):
                i = (t * per_thread + j) % len(imgs)
                t0 = time.perf_counter()
                f = mb.submit(imgs[i])
                f.add_done_callback(lambda f, t0=t0, i=i: lat.append(
                    (time.perf_counter() - t0) * 1e3))
                futs.append((i, f))
            got = [(i, f.result(timeout=300)) for i, f in futs]
            with lock:
                results.extend(got)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        secs = time.perf_counter() - t0
        mb.close()
        return mb, results, lat, secs

    # 32 requests from 4 client threads at once
    groups.clear()
    mb, results, lat, secs = run_clients(4, 8)
    if len(results) != 32 or sum(mb.batch_sizes) != 32:
        raise AssertionError(f"micro-batching: {len(results)} results, "
                             f"batches {mb.batch_sizes}")
    least, mean = hold(results, "4 clients")
    entry["concurrent_4x8"] = {
        "requests_per_s": 32 / secs, "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)),
        "batch_sizes": dict(sorted(Counter(mb.batch_sizes).items())),
        "least_share_matching_single": least,
        "mean_share_matching_single": mean}
    c = entry["concurrent_4x8"]
    print(f"  MicroBatcher (max_batch 8, max_delay_ms 4, pipeline_depth 2), "
          f"32 requests from 4 threads at once on {card}: "
          f"{c['requests_per_s']:.2f} requests/s, per request p50 "
          f"{c['p50_ms']:.2f} ms, p90 {c['p90_ms']:.2f}; batch sizes "
          f"{c['batch_sizes']}; every future's rows bit-equal to its "
          f"frame's in predict_batch of its group; rows matching the "
          f"frame's single request within 1e-2 px and 1e-4: least share "
          f"{least:.4f}, mean {mean:.4f}", flush=True)

    # a closed loop of 16 beside the single predict calls
    groups.clear()
    mb = MicroBatcher(pred)
    lat, results = [], []
    t0 = time.perf_counter()
    for r in range(16):
        i = r % len(imgs)
        t = time.perf_counter()
        results.append((i, mb.submit(imgs[i]).result(timeout=300)))
        lat.append((time.perf_counter() - t) * 1e3)
    secs = time.perf_counter() - t0
    mb.close()
    least, _ = hold(results, "closed loop")
    if set(mb.batch_sizes) == {1} and least != 1.0:
        raise AssertionError("micro-batching closed loop: single-request "
                             "groups differ from predict")
    # the same single predict calls from a thread of their own, as the
    # batcher's worker makes them: the thread's share of the closed loop
    threaded = []
    th = threading.Thread(target=lambda: threaded.extend(
        serve_times(pred, imgs)[0]))
    th.start()
    th.join(timeout=300)
    entry["closed_loop_16"] = {
        "requests_per_s": 16 / secs, "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)),
        "batch_sizes": dict(sorted(Counter(mb.batch_sizes).items())),
        "least_share_matching_single": least,
        "single_in_a_thread_p50_ms": float(np.percentile(threaded, 50))}
    c = entry["closed_loop_16"]
    print(f"  MicroBatcher closed loop of 16 on {card}: "
          f"{c['requests_per_s']:.2f} requests/s, p50 {c['p50_ms']:.2f} ms, "
          f"p90 {c['p90_ms']:.2f}, batch sizes {c['batch_sizes']}; single "
          f"predict calls: p50 {entry['single_p50_ms']:.2f} ms, p90 "
          f"{entry['single_p90_ms']:.2f}, {entry['single_requests_per_s']:.2f}"
          f" requests/s; the same calls from a second thread: p50 "
          f"{c['single_in_a_thread_p50_ms']:.2f} ms", flush=True)

    # per-class soft-NMS through the batcher: B.2 at its batch sizes
    model.nms_type = "soft_nms"
    pred.warmup(batch_sizes=(1, 2, 4, 8))
    forwards = []
    hook = model.register_forward_hook(
        lambda module, args, kwargs, out: forwards.append(
            (out, kwargs.get("valid_hw"))), with_kwargs=True)
    torch.cuda.synchronize()
    zero_int8_counts()                                   # just before
    mb, results, lat, secs = run_clients(4, 2)
    torch.cuda.synchronize()
    counts = int8_counts(torch)                          # just after
    hook.remove()
    groups.clear()
    pred.stage = stage
    want = {"hard_nms": 0, "soft_nms": 0,
            "soft_nms_classes": len(mb.batch_sizes), "dcn": 0,
            "int8_conv2d": 0, "int8_quantize_pack": 0}
    if counts != want or len(forwards) != len(mb.batch_sizes):
        raise AssertionError(f"micro-batching with soft-NMS launched "
                             f"{counts} in {len(forwards)} forwards (want "
                             f"{want})")
    # the largest batch's ROI selection redone with the plain serial
    # soft-NMS per class
    out, vhw = max(forwards, key=lambda f: f[0].rois.shape[0])
    m = model
    with torch.inference_mode():
        hm = mask_heatmap_extent(out.hms[-1].float(), vhw, 4)
        dets = topk_decode(hm, out.whs[-1].float(), out.offsets[-1].float(),
                           k=m.topk)
        ns, keep, _ = sn.soft_nms_reference(
            dets.boxes, dets.scores, None, dets.classes,
            sigma=m.soft_nms_sigma, iou_threshold=m.nms_iou,
            score_threshold=m.soft_nms_score_threshold, method="gaussian",
            max_out=m.stage2_rois)
        top, idx = topk_desc(torch.where(keep, ns, -torch.inf),
                             m.stage2_rois)
        valid = top > -torch.inf
        rois = torch.gather(dets.boxes, 1, idx[..., None].expand(-1, -1, 4))
        same = (torch.equal(valid, out.roi_valid)
                and torch.equal(rois, out.rois)
                and torch.equal(torch.gather(dets.classes, 1, idx),
                                out.roi_classes))
    m.nms_type = "nms"
    if not same:
        raise AssertionError("micro-batching soft-NMS ROIs differ from the "
                             "plain serial soft-NMS's")
    entry["soft_nms_4x2"] = {
        "requests_per_s": 8 / secs, "p50_ms": float(np.percentile(lat, 50)),
        "p90_ms": float(np.percentile(lat, 90)),
        "batch_sizes": dict(sorted(Counter(mb.batch_sizes).items())),
        "soft_nms_classes_launches": counts["soft_nms_classes"],
        "checked_batch": int(out.rois.shape[0])}
    c = entry["soft_nms_4x2"]
    print(f"  MicroBatcher with per-class soft-NMS, 8 requests from 4 "
          f"threads on {card}: {c['requests_per_s']:.2f} requests/s, p50 "
          f"{c['p50_ms']:.2f} ms, p90 {c['p90_ms']:.2f}; batch sizes "
          f"{c['batch_sizes']}; launches {counts} (B.2 once a batch); the "
          f"batch of {c['checked_batch']}'s ROIs equal to the plain serial "
          f"soft-NMS's", flush=True)
    del mb, pred, model
    return entry


def sha(t):
    """sha256 of a tensor's bytes (on the host), for a bitwise comparison
    across processes."""
    import hashlib
    import torch
    a = t.detach().contiguous().cpu()
    if a.dim() == 0:
        a = a.reshape(1)
    return hashlib.sha256(a.view(torch.uint8).numpy().tobytes()).hexdigest()


def dp_rank(rank, world, port, out_path, ckpt_dir):
    """One rank of phase "data-parallel path" (a, b), started by
    `run_data_parallel` in a process of its own on cuda:0, its
    collectives over gloo: the flagship preset at full width (bf16, 2
    crops of 512x512 a rank) takes 5 steps at its defaults, one with
    per-class soft-NMS (B.2), and one in which only rank 1's batch holds
    an inf; then the tiny f32 two-rank step on the card against the same
    step on the CPU: `check_small_train`'s tolerances (losses 1e-4, ROI
    selection equal, boxes 1e-3; gradients 1e-3 of their largest
    magnitude with the CPU's ROIs fed to the card's stage 2 bit for bit,
    its hard-NMS route), except that a gradient may differ by up to twice
    what the CPU alone moves it when its normalised input is moved by a
    relative 1e-6: SyncBN mixes the two ranks' batches, and on these the
    f32 gradients sit on ReLU kinks (the CPU alone moves
    `offset.conv1.weight` by 15%, the backbone's by ~0.5%). Writes its
    numbers and the sha256 of every tensor of its state to `out_path`;
    rank 0 also saves its checkpoint under `ckpt_dir`."""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from rrnet_torch.ops import hard_nms as hn
    from rrnet_torch.ops import soft_nms as sn
    from rrnet_torch.parallel import create_group, mesh, shard_batch
    from rrnet_torch.profile_train import synthetic_batch, train_config
    from rrnet_torch.train import Trainer
    from rrnet_torch.utils import checkpoint as ckpt

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    cfg = train_config()
    dg = create_group(cfg.mesh, "cuda:0")
    out = {"rank": rank, "world": dg.world_size}
    t0 = time.perf_counter()
    tr = Trainer(cfg, device="cuda:0", group=dg)
    state = tr.init_state(generator=torch.Generator().manual_seed(cfg.seed))
    out["n_bn"] = sum(type(m).__name__ == "BatchNorm"
                      for m in tr.model.modules())
    out["built_s"] = time.perf_counter() - t0
    batch = shard_batch(synthetic_batch(np.random.RandomState(cfg.seed),
                                        b=2 * world), dg)

    def step(b):
        nonlocal state
        torch.cuda.synchronize()
        c0, t = mesh.collectives, time.perf_counter()
        state, m = tr.train_step(state, b)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t) * 1e3, mesh.collectives - c0,
                {k: float(v) for k, v in m.items()})

    hn.launches = sn.launches = sn.classes_launches = 0      # just before
    runs = [step(batch) for _ in range(5)]
    out["defaults"] = {
        "ms": [r[0] for r in runs], "collectives_per_step": runs[-1][1],
        "totals": [r[2]["total"] for r in runs],
        "skipped": [r[2]["skipped"] for r in runs],
        "launches": {"hard_nms": hn.launches, "soft_nms": sn.launches,
                     "soft_nms_classes": sn.classes_launches}}  # just after
    tr.model.nms_type = "soft_nms"
    hn.launches = sn.launches = sn.classes_launches = 0
    ms, _, m = step(batch)
    out["soft_nms"] = {"ms": ms, "total": m["total"],
                       "launches": {"hard_nms": hn.launches,
                                    "soft_nms": sn.launches,
                                    "soft_nms_classes": sn.classes_launches}}
    tr.model.nms_type = "nms"
    bad = batch if rank != 1 else dict(
        batch, images=np.full(batch["images"].shape, np.inf, np.float32))
    before = {k: sha(v) for k, v in state.tensors().items()}
    _, _, m = step(bad)
    out["inf"] = {"skipped": m["skipped"], "total": m["total"],
                  "state_unchanged": before == {
                      k: sha(v) for k, v in state.tensors().items()}}
    out["sha256"] = {k: sha(v) for k, v in state.tensors().items()}
    if rank == 0:
        out["checkpoint"] = ckpt.save_checkpoint(ckpt_dir, state)
    # the collectives of a step alone, both ranks at once: the flat
    # gradient, and one SyncBN's moments (2 x 256 f32)
    out["all_reduce_ms"] = {}
    for name, n, reps in (("flat_gradient", state.flat_params.numel(), 3),
                          ("syncbn_2x256", 512, 50)):
        x = torch.ones(n, dtype=torch.float32, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        out["all_reduce_ms"][name] = (time.perf_counter() - t) * 1e3 / reps
    del tr, state, x
    torch.cuda.empty_cache()

    # (b) the tiny f32 two-rank step, card against CPU
    outs = {}
    cpu, gpu, st, b = small_train_setup(torch, "soft_nms", group=dg,
                                        batch_seed=4 + rank)

    def keep(name):
        def hook(mod, args, out):
            outs[name] = out            # returns None: the output stands
        return hook
    hooks = [t.model.register_forward_hook(keep(name))
             for name, t in (("cpu", cpu), ("cuda", gpu))]
    gst = st.to("cuda")
    _, g_c = cpu.loss_and_grads(st, b)
    _, g_g = gpu.loss_and_grads(gst, b)
    for h in hooks:
        h.remove()
    a, c = outs["cpu"], outs["cuda"]
    same = all(torch.equal(getattr(a, k), getattr(c, k).cpu())
               for k in ("roi_valid", "roi_classes"))
    roi_gap = float((c.rois.detach().cpu() - a.rois.detach()).abs().max())
    own = grad_gaps(g_c, g_g)
    # the card's stage 2 fed the CPU's ROIs bit for bit (gradients still
    # reach the boxes), as `explain_small_train_gap` does
    cpu_rois = a.rois.detach()
    select = type(gpu.model).select_rois.__get__(gpu.model)

    def fed(boxes, scores, classes):
        out = select(boxes, scores, classes)
        rois = out[0] + (cpu_rois.to(out[0].device) - out[0]).detach()
        return (rois,) + tuple(out[1:])
    gpu.model.select_rois = fed
    _, g_f = gpu.loss_and_grads(gst, b)
    del gpu.model.select_rois
    errs = grad_gaps(g_c, g_f)
    # the CPU's own spread: the same step with its normalised input
    # moved by a relative 1e-6 (the size of the card's f32 differences)
    normalise, gen = cpu.normalise, torch.Generator().manual_seed(rank)
    cpu.normalise = lambda images: (lambda x: x * (1.0 + 1e-6 * torch.randn(
        x.shape, generator=gen)))(normalise(images))
    _, g_n = cpu.loss_and_grads(st, b)
    del cpu.normalise
    spread = dict((k, e) for e, k in grad_gaps(g_c, g_n))
    beyond = [(e, k, spread[k]) for e, k in errs
              if e > 1e-3 and e > 2.0 * spread[k]]
    _, m_c = cpu.train_step(st, b)
    _, m_g = gpu.train_step(gst, b)
    worst = max(abs(float(m_g[k]) - float(m_c[k]))
                / max(abs(float(m_c[k])), 1e-30) for k in m_c)
    out["small"] = {"rois_equal": same, "roi_gap": roi_gap,
                    "n_rois": int(a.roi_valid.sum()),
                    "own_roi_grad_gaps": own[:6],
                    "grad_gap": errs[0][0], "grad_worst": errs[0][1],
                    "n_grads": len(errs), "loss_gap": worst,
                    "n_within_1e-3": sum(e <= 1e-3 for e, _ in errs),
                    "beyond_1e-3": [(e, k, spread[k]) for e, k in errs
                                    if e > 1e-3],
                    "unexplained": beyond,
                    "s2": float(m_c["s2"]),
                    "params_sha256": sha(gst.flat_params)}
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_data_parallel(torch, card):
    """Phase "data-parallel path". (a) two ranks on cuda:0 over gloo, each
    a process of its own with a hard timeout (`dp_rank`), the flagship
    preset at full width: 5 steps at the defaults, one with per-class
    soft-NMS (B.2 counted on each rank), one with an inf batch on rank 1
    alone; both ranks skip, and their params, moments, counts, step and
    SyncBN statistics are bitwise equal. (b) in the same ranks, the tiny
    f32 two-rank step on the card against the CPU. (c) a one-rank NCCL
    group from the environment (`parallel.init_from_env`): the full-width
    step p50 in it and in the plain Trainer, in turns, and the flat
    gradient's all-reduce (765 MB of f32) under NCCL and under gloo.
    (d) `python -m rrnet_torch.scripts.eval --data-parallel` on the
    synthetic split writes the same result files, byte for byte, as
    without the flag (rank 0's checkpoint of (a)). Returns (the JSON
    entry, hard_nms and soft_nms_classes launches of each rank)."""
    import socket
    import subprocess
    import tempfile
    import torch.distributed as dist
    from rrnet_torch.data.synth import make_synth_dataset
    from rrnet_torch.models.layers import set_sync_group
    from rrnet_torch.parallel import create_group, init_from_env, mesh
    from rrnet_torch.profile_train import synthetic_batch, train_config
    from rrnet_torch.scripts import eval as eval_cli
    from rrnet_torch.train import Trainer

    def free_port():
        with socket.socket() as so:
            so.bind(("localhost", 0))
            return so.getsockname()[1]

    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    entry = {}
    # (a) and (b): two ranks on cuda:0 over gloo
    port, world = free_port(), 2
    procs = []
    t0 = time.perf_counter()
    for r in range(world):
        log = open(os.path.join(tmp.name, f"rank{r}.log"), "w")
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke;"
                f" chip_smoke.dp_rank({r}, {world}, {port}, "
                f"{os.path.join(tmp.name, f'rank{r}.json')!r}, "
                f"{os.path.join(tmp.name, 'ckpt')!r})")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       cwd=HERE, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + 300
    try:
        while any(p.poll() is None for p, _ in procs):
            if (any(p.poll() not in (None, 0) for p, _ in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=60)
            log.close()
    logs = [open(log.name).read() for _, log in procs]
    for r, ((p, _), text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"data-parallel rank {r} exited with "
                                 f"{p.returncode}:\n{text[-6000:]}")
    ranks = [json.load(open(os.path.join(tmp.name, f"rank{r}.json")))
             for r in range(world)]
    entry["two_ranks_s"] = time.perf_counter() - t0
    r0, r1 = ranks
    want = {"hard_nms": 5, "soft_nms": 0, "soft_nms_classes": 0}
    want_soft = {"hard_nms": 0, "soft_nms": 0, "soft_nms_classes": 1}
    per_step = 2 * r0["n_bn"] + 3
    for r in ranks:
        d = r["defaults"]
        if (d["launches"] != want or r["soft_nms"]["launches"] != want_soft
                or d["collectives_per_step"] != per_step):
            raise AssertionError(f"rank {r['rank']}: launches "
                                 f"{d['launches']} / soft-NMS "
                                 f"{r['soft_nms']['launches']}, "
                                 f"{d['collectives_per_step']} collectives "
                                 f"a step (want {want}, {want_soft}, "
                                 f"{per_step})")
        if (not all(np.isfinite(d["totals"])) or any(d["skipped"])
                or not d["totals"][-1] < d["totals"][0]):
            raise AssertionError(f"rank {r['rank']}: totals {d['totals']}, "
                                 f"skipped {d['skipped']}")
        if r["inf"]["skipped"] != 1.0 or not r["inf"]["state_unchanged"]:
            raise AssertionError(f"rank {r['rank']}: inf batch on rank 1 "
                                 f"{r['inf']}")
        sm = r["small"]
        if not (sm["rois_equal"] and sm["roi_gap"] <= 1e-3
                and not sm["unexplained"] and sm["loss_gap"] <= 1e-4
                and sm["s2"] > 0):
            raise AssertionError(f"rank {r['rank']}: tiny two-rank step "
                                 f"cuda vs cpu {sm}")
    if r0["sha256"] != r1["sha256"]:
        diff = [k for k in r0["sha256"] if r0["sha256"][k] != r1["sha256"][k]]
        raise AssertionError(f"the two ranks' states differ in {diff}")
    if r0["defaults"]["totals"] != r1["defaults"]["totals"]:
        raise AssertionError("the two ranks logged other totals")
    if r0["small"]["params_sha256"] != r1["small"]["params_sha256"]:
        raise AssertionError("tiny two-rank step: the ranks' params differ")
    ms = [x for r in ranks for x in r["defaults"]["ms"][1:]]
    entry["two_ranks_gloo_cuda0"] = {
        "preset": "rrnet", "images_per_rank": 2, "crop": [512, 512],
        "bn": r0["n_bn"], "collectives_per_step": per_step,
        "step_ms": [r["defaults"]["ms"] for r in ranks],
        "step_p50_ms": float(np.percentile(ms, 50)),
        "soft_nms_step_ms": [r["soft_nms"]["ms"] for r in ranks],
        "launches": [{"defaults": r["defaults"]["launches"],
                      "soft_nms": r["soft_nms"]["launches"]} for r in ranks],
        "totals": r0["defaults"]["totals"], "built_s": r0["built_s"],
        "all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
        "state_sha256_equal": True, "inf_on_rank1_skipped_both": True}
    entry["tiny_two_ranks_cuda_vs_cpu"] = [r["small"] for r in ranks]
    print(f"  two ranks on cuda:0 over gloo (rrnet, full width, bf16, 2 x "
          f"512x512 a rank): 5 steps at the defaults, totals "
          f"{[round(x, 4) for x in r0['defaults']['totals']]}, step p50 "
          f"{entry['two_ranks_gloo_cuda0']['step_p50_ms']:.2f} ms (both "
          f"ranks on one card; {[[round(x, 1) for x in r['defaults']['ms']] for r in ranks]}); "
          f"{per_step} collectives a step ({r0['n_bn']} SyncBN forward + "
          f"backward, gradient, skip flag, metrics); launches per rank "
          f"{r0['defaults']['launches']}, soft-NMS step "
          f"{r0['soft_nms']['launches']}; inf on rank 1 alone: both "
          f"skipped, state bitwise unchanged; params, moments, counts, "
          f"step and SyncBN statistics sha256-equal on both ranks; alone, "
          f"an all_reduce over gloo of the flat gradient "
          f"{r0['all_reduce_ms']['flat_gradient']:.2f} ms and of one "
          f"SyncBN's moments (2 x 256 f32) "
          f"{r0['all_reduce_ms']['syncbn_2x256']:.3f} ms (rank 0)",
          flush=True)
    for r in ranks:
        sm = r["small"]
        print(f"  rank {r['rank']}: tiny two-rank step f32 (soft-NMS) cuda == "
              f"cpu: {sm['n_rois']} ROIs equal (boxes within "
              f"{sm['roi_gap']:.3g}); losses within {sm['loss_gap']:.3g} "
              f"(s2 {sm['s2']:.4f}); with the card's own ROIs the worst "
              f"gradients {[(round(e, 5), k) for e, k in sm['own_roi_grad_gaps'][:3]]}; "
              f"with the CPU's ROIs fed {sm['n_within_1e-3']} of "
              f"{sm['n_grads']} all-meaned gradients within 1e-3 of their "
              f"largest magnitude, the others (gap, name, the CPU's own "
              f"shift under 1e-6 input noise) "
              f"{[(round(e, 5), k, round(n, 5)) for e, k, n in sm['beyond_1e-3'][:12]]}"
              f"{' ...' if len(sm['beyond_1e-3']) > 12 else ''}", flush=True)

    # (c) a one-rank NCCL group from the environment
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    dev = init_from_env("cuda", timeout_s=120)
    try:
        cfg = train_config()
        dg = create_group(cfg.mesh, dev)
        tr = Trainer(cfg, device=dev, group=dg)
        state = tr.init_state(generator=torch.Generator().manual_seed(
            cfg.seed))
        batch = synthetic_batch(np.random.RandomState(cfg.seed))
        times = {"nccl_world1": [], "plain": []}
        c0 = mesh.collectives
        for mode in ("plain", "nccl_world1", "nccl_world1", "plain"):
            group = dg if mode != "plain" else None
            tr.group = group
            set_sync_group(tr.model, group)
            for i in range(4):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, _ = tr.train_step(state, batch)
                torch.cuda.synchronize()
                if i:
                    times[mode].append((time.perf_counter() - t) * 1e3)
        issued = mesh.collectives - c0
        flat = torch.ones(state.flat_params.numel(), dtype=torch.float32,
                          device=dev)
        del tr, state
        gloo = dist.new_group(backend="gloo")
        reduce_ms = {}
        for name, group, reps in (("nccl", None, 10), ("gloo", gloo, 3)):
            for _ in range(2):
                dist.all_reduce(flat, group=group)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                dist.all_reduce(flat, group=group)
            torch.cuda.synchronize()
            reduce_ms[name] = (time.perf_counter() - t) * 1e3 / reps
    finally:
        dist.destroy_process_group()
    entry["one_rank_nccl"] = {
        "step_p50_ms": float(np.percentile(times["nccl_world1"], 50)),
        "plain_step_p50_ms": float(np.percentile(times["plain"], 50)),
        "step_ms": times, "collectives_issued": issued,
        "flat_grad_bytes": flat.numel() * 4,
        "all_reduce_ms": reduce_ms}
    if issued:
        raise AssertionError(f"a world of one rank issued {issued} "
                             "collectives")
    c = entry["one_rank_nccl"]
    print(f"  one-rank NCCL group from the environment on {card}: step p50 "
          f"{c['step_p50_ms']:.2f} ms against the plain Trainer's "
          f"{c['plain_step_p50_ms']:.2f} (4x512x512, in turns plain, group, "
          f"group, plain; {issued} collectives issued); all_reduce of the "
          f"flat gradient ({c['flat_grad_bytes'] / 1e6:.1f} MB f32) at world "
          f"1: NCCL {reduce_ms['nccl']:.3f} ms, gloo {reduce_ms['gloo']:.3f} "
          f"ms (no multi-card number: one card)", flush=True)

    # (d) the eval CLI with and without --data-parallel
    root = os.path.join(tmp.name, "synth")
    make_synth_dataset(root, n_train=1, n_val=4, seed=219)

    def run_eval(name, *extra):
        res = eval_cli.main(["--config", "rrnet", "--ckpt",
                             os.path.join(tmp.name, "ckpt"), "--no-score",
                             *extra, f"data_root={root}",
                             f"val.result_dir={os.path.join(tmp.name, name)}"])
        d = res["result_dir"]
        return {f: open(os.path.join(d, f), "rb").read()
                for f in sorted(os.listdir(d))}

    t0 = time.perf_counter()
    plain = run_eval("plain")
    split = run_eval("split", "--data-parallel")
    if plain != split or len(plain) != 4:
        raise AssertionError(f"eval --data-parallel wrote other files "
                             f"({len(plain)} / {len(split)})")
    entry["eval_data_parallel"] = {
        "devices": eval_cli.local_devices("cuda"), "files": len(plain),
        "rows": sum(v.count(b"\n") for v in plain.values()),
        "byte_equal": True, "seconds": time.perf_counter() - t0}
    print(f"  python -m rrnet_torch.scripts.eval --data-parallel (devices "
          f"{entry['eval_data_parallel']['devices']}) on the synthetic val "
          f"split (4 images, rank 0's checkpoint): "
          f"{entry['eval_data_parallel']['files']} result files byte-equal "
          f"to the run without the flag "
          f"({entry['eval_data_parallel']['rows']} rows)", flush=True)
    tmp.cleanup()
    launches = {"hard_nms": [r["defaults"]["launches"]["hard_nms"]
                             for r in ranks],
                "soft_nms_classes": [r["soft_nms"]["launches"][
                    "soft_nms_classes"] for r in ranks]}
    return entry, launches


def rect_oracle(h, w, p1, p2):
    """The pixels of `cv2.rectangle(p1, p2, thickness=1)` on an h x w
    image, as (rows, cols): every integer point of each of the four edges
    between its corners, kept where it lies inside the image."""
    (x1, y1), (x2, y2) = p1, p2
    pts = []
    for (ax, ay), (bx, by) in (((x1, y1), (x2, y1)), ((x2, y1), (x2, y2)),
                               ((x2, y2), (x1, y2)), ((x1, y2), (x1, y1))):
        n = max(abs(bx - ax), abs(by - ay)) + 1
        xs = np.linspace(ax, bx, n).round().astype(np.int64)
        ys = np.linspace(ay, by, n).round().astype(np.int64)
        pts.append(np.stack([ys, xs], 1))
    pts = np.concatenate(pts)
    pts = pts[(pts[:, 0] >= 0) & (pts[:, 0] < h) & (pts[:, 1] >= 0)
              & (pts[:, 1] < w)]
    return pts[:, 0], pts[:, 1]


def run_reference_tools(torch, hn, card):
    """Phase 15 (module docstring): the converted reference checkpoint,
    roi_jitter, DCNPooling, k-means and `visualize` on the card, the
    hard-NMS launch count of the phase read just after it. Returns the
    phase's numbers."""
    import tempfile
    from rrnet_torch import config
    from rrnet_torch.data.synth import make_synth_dataset
    from rrnet_torch.data.visdrone import parse_annotation_file
    from rrnet_torch.models import build_model
    from rrnet_torch.models.layers import init_weights
    from rrnet_torch.models.modules import DCNPooling
    from rrnet_torch.ops.kmeans import kmeans
    from rrnet_torch.serving import Predictor
    from rrnet_torch.utils import convert
    from rrnet_torch.utils.vis import TAB20, visualize

    out = {"card": card}
    cfg = config.rrnet_config()
    hn.launches = 0                                          # counts to 0
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    sd = model.state_dict()
    n_params = sum(p.numel() for p in model.parameters())
    ref = convert.reference_state_dict(
        lambda t: convert.detector_table(t, "rrnet", cfg.model.num_stacks),
        sd)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rrnet_reference.pth")
        torch.save({"model": {"module." + k: v for k, v in ref.items()}},
                   path)
        del ref
        t0 = time.perf_counter()
        loaded = convert.load_torch_state_dict(path)
        converted, report = convert.convert_detector_params(
            loaded, model="rrnet", num_stacks=cfg.model.num_stacks)
        convert_s = time.perf_counter() - t0
    if report["unexpected"]:
        raise AssertionError(f"unexpected keys {report['unexpected'][:5]}")
    other = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed + 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    other.load_state_dict(converted, strict=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    bad = [k for k, v in other.state_dict().items()
           if not torch.equal(v, sd[k])]
    if bad:
        raise AssertionError(f"converted tensors differ: {bad[:5]}")
    frame = demo_frames(1)[0]["image"]
    direct = Predictor(cfg, model, device="cuda").predict(frame)
    via = Predictor(cfg, other, device="cuda").predict(frame)
    if not np.array_equal(direct, via):
        raise AssertionError("the converted checkpoint serves other "
                             "detections")
    check_detections(direct, cfg.model.stage2_rois, cfg.num_classes)
    out["checkpoint"] = {"params": n_params, "tensors": len(converted),
                         "convert_s": convert_s, "load_s": load_s,
                         "rows": int(len(direct))}
    print(f"  converted reference checkpoint: {n_params} params in "
          f"{len(converted)} tensors, read and converted in {convert_s:.2f}"
          f" s, loaded strictly in {load_s:.2f} s; {len(direct)} served "
          f"rows bit-equal to the direct load ({card})", flush=True)
    del converted, loaded, other

    # (b) roi_jitter at full width
    mean = np.asarray(cfg.val.mean, np.float32)
    std = np.asarray(cfg.val.std, np.float32)
    img = np.zeros((768, 1408, 3), np.float32)
    img[:765, :1360] = (frame.astype(np.float32) / 255.0 - mean) / std
    x = torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).cuda()
    r = cfg.model.stage2_rois
    jit = torch.randn(1, r, 4, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        plain = model(x)
        jittered = model(x, roi_jitter=jit.cuda())
        zero = model(x, roi_jitter=torch.zeros(1, r, 4, device="cuda"))
        feat = torch.relu(model.backbone(x)[-1]).float()
    if not torch.equal(jittered.rois, plain.rois + jit.cuda()):
        raise AssertionError("jittered ROIs are not the ROIs + the jitter")
    for a, b in zip(zero, plain):
        for ta, tb in zip(a if isinstance(a, tuple) else (a,),
                          b if isinstance(b, tuple) else (b,)):
            if not torch.equal(ta, tb):
                raise AssertionError("a zero roi_jitter changed an output")
    moved = float((jittered.stage2_reg.float()
                   - plain.stage2_reg.float()).abs().mean())
    out["roi_jitter"] = {"sigma_feature_px": 1.0, "rois": r,
                         "stage2_delta_mean_abs_change": moved}
    print(f"  roi_jitter: {r} ROIs moved by the jitter exactly, zero "
          f"jitter bit-equal, stage-2 deltas moved {moved:.4g} on mean "
          f"({card})", flush=True)

    # (c) DCNPooling at the reference defaults
    pool = init_weights(DCNPooling(spatial_scale=0.25),
                        torch.Generator().manual_seed(3))
    with torch.no_grad():
        pool.fc3.weight.normal_(0.0, 0.01,
                                generator=torch.Generator().manual_seed(4))
    b_idx = torch.zeros(r, 1, device="cuda")
    rois = torch.cat([b_idx, plain.rois[0] * 4.0], 1)
    with torch.no_grad():
        want = pool(feat.cpu(), rois.cpu())
        pool.cuda()
        got = pool(feat, rois)
        err = float((got.cpu() - want).abs().max())
        ms = cuda_ms(lambda: pool(feat, rois), reps=10)
    if not err <= 1e-4:
        raise AssertionError(f"DCNPooling on the card is {err} from the CPU")
    out["dcn_pooling"] = {"feat": list(feat.shape), "rois": r,
                          "max_abs_err_vs_cpu": err, "ms": ms}
    print(f"  DCNPooling {list(feat.shape)} x {r} ROIs: {ms:.3f} ms a call, "
          f"{err:.3g} from the CPU ({card})", flush=True)
    del feat, pool

    # (d) k-means of the synthetic set's GT sizes
    root = make_synth_dataset(os.path.join(HERE, "build", "ref_tools_synth"),
                              n_train=32, n_val=8, seed=219)
    ann = os.path.join(root, "train", "annotations")
    wh = np.concatenate([parse_annotation_file(os.path.join(ann, f))[:, 2:4]
                         for f in sorted(os.listdir(ann))]).astype(np.float32)
    priors = {}
    for axis, name in ((1, "heights"), (0, "widths")):
        col = torch.from_numpy(wh[:, axis:axis + 1].copy())
        c_cpu, a_cpu = kmeans(col, 3, seed=0)
        col_cuda = col.cuda()
        c_gpu, a_gpu = kmeans(col_cuda, 3, seed=0)
        if not torch.equal(a_gpu.cpu(), a_cpu) or not np.allclose(
                c_gpu.cpu().numpy(), c_cpu.numpy(), rtol=1e-5, atol=0):
            raise AssertionError(f"k-means {name}: the card differs")
        priors[name] = sorted(float(v) for v in c_gpu.cpu().ravel())
        priors[name + "_ms"] = cuda_ms(lambda: kmeans(col_cuda, 3, seed=0),
                                       reps=5)
    out["kmeans"] = {"boxes": int(len(wh)), "k": 3, **priors}
    print(f"  k-means over {len(wh)} GT boxes: heights {priors['heights']}"
          f", widths {priors['widths']}; {priors['heights_ms']:.2f} ms a "
          f"call on the card, equal to the CPU ({card})", flush=True)

    # (e) visualize the served detections
    blank = np.zeros_like(frame)
    drawn = visualize(blank, direct)
    if drawn.shape != (frame.shape[0] + 14,) + frame.shape[1:]:
        raise AssertionError(f"visualize gave {drawn.shape}")
    oracle = np.zeros_like(frame)
    h, w = frame.shape[:2]
    for row in direct:
        x0, y0 = int(row[0]), int(row[1])
        ys, xs = rect_oracle(h, w, (x0, y0), (int(row[0] + row[2]),
                                              int(row[1] + row[3])))
        oracle[ys, xs] = TAB20[int(row[5]) % len(TAB20)]
    if not np.array_equal(drawn[:h], oracle):
        raise AssertionError("visualize's boxes differ from the oracle")
    out["visualize"] = {"shape": list(drawn.shape), "boxes": int(len(direct)),
                        "box_pixels": int((oracle.sum(-1) > 0).sum())}
    torch.cuda.synchronize()
    out["hard_nms_launches"] = hn.launches                   # just after
    print(f"  visualize: {drawn.shape}, {len(direct)} boxes equal to the "
          f"oracle; {hn.launches} hard-NMS launches in the phase ({card})",
          flush=True)
    return out



def main(argv=None) -> int:
    import argparse
    from pathlib import Path
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", metavar="DIR", help="a directory holding "
                    "another version of some of rrnet_torch/csrc's sources "
                    "(the DCN trio dcn_fwd.cu, dcn_bwd.cu, dcn_common.cuh; "
                    "soft_nms_classes.cu; soft_nms.cu; int8_conv.cu of "
                    "5cd1773's interface; hard_nms.cu of 0fe0581's "
                    "interface), e.g. the parent commit's; its "
                    "kernels are built into DIR/build and timed beside this "
                    "checkout's, in turns")
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
    native.build_all(tuple(native.SOURCES) + tuple(native.HOST_SOURCES))
    secs = time.perf_counter() - t0
    print(f"  kernels {sorted(native.SOURCES)} and the host library "
          f"{sorted(native.HOST_SOURCES)} built in {secs:.1f} s", flush=True)
    for name in native.SOURCES:
        for line in native.build_log(name):
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    before_pair = before_classes = before_soft = before_i8 = None
    before_hard = None
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
        if (src / "int8_conv.cu").exists():
            before_i8 = before_int8(torch, src)
        if (src / "hard_nms.cu").exists():
            before_hard = before_hard_nms(torch, src)
        if before_pair is None and before_classes is None and (
                before_soft is None) and before_i8 is None and (
                    before_hard is None):
            raise SystemExit(f"--before {src}: no DCN trio, no "
                             "soft_nms_classes.cu, no soft_nms.cu, no "
                             "int8_conv.cu and no hard_nms.cu there")
        print(f"  the kernels of {src} ("
              + ", ".join(n for n, b in (("DCN", before_pair),
                                         ("soft_nms_classes",
                                          before_classes),
                                         ("soft_nms", before_soft),
                                         ("int8_conv", before_i8),
                                         ("hard_nms", before_hard)) if b)
              + f") built in {time.perf_counter() - t0:.1f} s", flush=True)

    phase("kernels vs plain")
    rng = np.random.RandomState(0)
    soft_err, soft_cases = check_soft_nms(torch, sn, rng)
    soft = soft_nms_timings(torch, sn, soft_cases, card, before_soft)
    soft["max_abs_err"] = soft_err
    classes = check_soft_nms_classes(torch, sn, rng, card, before_classes)
    hard = check_hard_nms(torch, hn, rng, card, before_hard)
    dcn_fwd, dcn_bwd = check_dcn(torch, rng, card, before_pair)
    int8_conv, int8_pack = check_int8_conv(torch, rng, card, before_i8)
    epilogue = check_conv_epilogue(torch, card)

    phase("small-input reference")
    check_small_reference(torch)
    check_small_train(torch)
    check_small_trident(torch)

    phase("main path")
    counts, soft["served_frame"], hard["served_frame"] = run_main_path(
        torch, sn, hn, card, before_soft, before_hard)
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

    phase("eval protocol")
    t0 = time.perf_counter()
    protocol, hard["eval_protocol_launches"] = run_eval_protocol(
        torch, hn, sn, card, before_hard)
    hard["six_scale_batch"] = protocol["rrnet_six_scales"]["hard_nms"]
    epilogue["launches"] = protocol["rrnet_six_scales"][
        "conv_epilogue_launches_per_batch"]
    print(f"  phase took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("retinanet path")
    t0 = time.perf_counter()
    retina, hard["retinanet_launches"] = run_retinanet_path(torch, sn, hn,
                                                            card)
    print(f"  phase took {time.perf_counter() - t0:.1f} s", flush=True)

    phase("hrnetv2-attention path")
    t0 = time.perf_counter()
    hrnet, hr_launches = run_hrnet_attention_path(torch, sn, hn, card)
    hrnet["seconds"] = time.perf_counter() - t0
    print(f"  phase took {hrnet['seconds']:.1f} s", flush=True)
    hard["hrnet_attention_launches"] = {
        "serving": hr_launches["hard_nms"],
        "train": hr_launches["hard_nms_train"],
        "eval": hr_launches["hard_nms_eval"]}
    classes["hrnet_attention_launches"] = hr_launches["soft_nms_classes"]

    phase("int8 path")
    t0 = time.perf_counter()
    int8 = run_int8_path(torch, card, before_i8)
    int8["seconds"] = time.perf_counter() - t0
    print(f"  phase took {int8['seconds']:.1f} s", flush=True)
    launches = int8["serve"]["launches"]
    int8_conv["launches"] = launches["int8_conv2d"]
    int8_pack["launches"] = launches["int8_quantize_pack"]
    for entry, key in ((int8_conv, "int8_conv2d"),
                       (int8_pack, "int8_quantize_pack")):
        entry["launches_per_forward"] = launches[key] / 16
        entry["six_scale_eval_launches"] = (
            int8["six_scales_int8"]["launches"][key])
    hard["int8_path_launches"] = launches["hard_nms"]

    phase("micro-batching")
    t0 = time.perf_counter()
    batching = run_microbatching(torch, card)
    batching["seconds"] = time.perf_counter() - t0
    print(f"  phase took {batching['seconds']:.1f} s", flush=True)
    classes["microbatching_launches"] = (
        batching["soft_nms_4x2"]["soft_nms_classes_launches"])

    phase("data-parallel path")
    t0 = time.perf_counter()
    data_parallel, dp_launches = run_data_parallel(torch, card)
    data_parallel["seconds"] = time.perf_counter() - t0
    print(f"  phase took {data_parallel['seconds']:.1f} s", flush=True)
    hard["data_parallel_launches"] = dp_launches["hard_nms"]
    classes["data_parallel_launches"] = dp_launches["soft_nms_classes"]

    phase("reference tools path")
    t0 = time.perf_counter()
    ref_tools = run_reference_tools(torch, hn, card)
    ref_tools["seconds"] = time.perf_counter() - t0
    print(f"  phase took {ref_tools['seconds']:.1f} s", flush=True)
    hard["reference_tools_launches"] = ref_tools["hard_nms_launches"]

    print(json.dumps({"data": data}), flush=True)
    print(json.dumps({"eval_protocol": protocol}), flush=True)
    print(json.dumps({"retinanet": retina}), flush=True)
    print(json.dumps({"hrnetv2_attention": hrnet}), flush=True)
    print(json.dumps({"int8": int8}), flush=True)
    print(json.dumps({"microbatching": batching}), flush=True)
    print(json.dumps({"data_parallel": data_parallel}), flush=True)
    print(json.dumps({"reference_tools": ref_tools}), flush=True)
    print(json.dumps({"kernels": [soft, classes, dcn_fwd, dcn_bwd, hard,
                                  int8_conv, int8_pack, epilogue]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
