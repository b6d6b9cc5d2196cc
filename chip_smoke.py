#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit from nvidia-smi;
  2. build: every CUDA kernel of the port from `rrnet_torch/csrc/`;
  3. kernels: each kernel against its plain PyTorch version on the card
     at the main path's shapes, plus edge cases, and timed;
  4. small-input reference: a tiny RRNet in f32 on the card against the
     same model on the CPU (the path the CPU tests hold to the JAX
     package);
  5. main path: `rrnet_torch.serving.Predictor` on the flagship `rrnet`
     preset with stage-1 soft-NMS (hourglass-104, 2 stacks, topk 1500,
     512 ROIs, bf16, seeded random weights) answers single requests and
     one batch inside the 768x1408 bucket; the kernel launch counts of
     that run are read back, and one request's ROI selection is redone
     with the plain soft-NMS.
Then one JSON line lists every kernel, and the last line is the result.
It exits non-zero without a result when no CUDA device is present.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# Roofline of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per candidate slot (active, unselected) and step of
# soft-NMS: the argmax compare, IoU (min/max/sub/add on both axes, clamps, inter, union,
# divide, overlap tests), the gaussian weight (mul, div, exp), the decay
# multiply and the threshold compare.
SOFT_NMS_OPS_PER_SLOT_STEP = 22


def phase(name):
    print(f"== {name}", flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


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


def check_soft_nms(torch, sn, rng):
    """Kernel vs plain version on the card; returns the kernel's line."""
    dev = torch.device("cuda")
    kw = dict(sigma=0.5, iou_threshold=0.7, score_threshold=0.1,
              method="gaussian")
    boxes, scores, cls = detections_like(rng, 4, 1500, 10)
    t = (lambda a: None if a is None else
         torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    eb, es, ec = boxes[:1, :300], scores[:1, :300], cls[:1, :300]
    ident = np.tile(np.array([[[10, 10, 20, 20]]], np.float32), (1, 64, 1))
    cases = [
        ("main B=4 K=1500 per-class", boxes, scores, None, cls, 512),
        ("K=1", boxes[:, :1], scores[:, :1], None, cls[:, :1], 512),
        ("all invalid", boxes[:, :40], scores[:, :40],
         np.zeros((4, 40), bool), cls[:, :40], 512),
        ("identical boxes", ident, np.linspace(1, .2, 64)[None]
         .astype(np.float32), None, None, 512),
        ("equal scores", eb, np.full_like(es, 0.5), None, ec, 512),
        ("max_out above survivors", boxes[:, :200], scores[:, :200], None,
         cls[:, :200], 4000),
        ("class-agnostic with valid mask", boxes, scores,
         rng.rand(4, 1500) > 0.1, None, 512),
    ]
    main_err = None
    for name, b, s, v, c, max_out in cases:
        args = (t(b), t(s), t(v), t(c))
        got = sn.soft_nms(*args, max_out=max_out, **kw)
        torch.cuda.synchronize()
        ref = sn.soft_nms_reference(*args, max_out=max_out, **kw)
        if not torch.equal(got[1], ref[1]) or not torch.equal(got[2], ref[2]):
            raise AssertionError(f"soft_nms kernel: keep/rank differ ({name})")
        k = ref[1]
        torch.testing.assert_close(got[0][k], ref[0][k], rtol=1e-5, atol=0)
        err = float((got[0][k] - ref[0][k]).abs().max()) if k.any() else 0.0
        print(f"  soft_nms {name}: keep {int(k.sum())} equal, rank equal, "
              f"max |score diff| {err:.3g}", flush=True)
        if main_err is None:
            main_err = err
            keep_main = ref[1]

    args = (t(boxes), t(scores), None, t(cls))
    ms = cuda_ms(lambda: sn.soft_nms(*args, max_out=512, **kw), reps=50)
    plain_ms = cuda_ms(lambda: sn.soft_nms_reference(*args, max_out=512,
                                                     **kw), reps=3, warm=1)
    # the work these inputs need: each step's argmax and decay touch the
    # active, unselected slots only
    work = sn.soft_nms_reference(*args, max_out=512, return_work=True,
                                 **kw)[3]
    bsz, kk = scores.shape
    ops = float(work.sum()) * SOFT_NMS_OPS_PER_SLOT_STEP
    nbytes = bsz * kk * ((16 + 4 + 4) + (4 + 1 + 4))
    bound_ops = ops / F32_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  soft_nms timing at B=4 K=1500: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {max(bound_ops, bound_bytes):.6f} ms "
          f"(candidate slot-steps per image {work.tolist()}, "
          f"{ops:.0f} ops, {nbytes} bytes); no PyTorch call computes "
          "soft-NMS, so library_ms is null", flush=True)
    return {"name": "soft_nms", "route": "cuda",
            "source": "rrnet_torch/csrc/soft_nms.cu",
            "replaces": "rrnet_tpu/ops/pallas_nms.py:45",
            "launches": None, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": None}


def check_small_reference(torch):
    """Tiny RRNet, f32: the card against the CPU on the same weights."""
    from rrnet_torch import config
    from rrnet_torch.models import build_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = config.rrnet_config(**{
        "model.backbone": "tiny_hourglass", "model.topk": 256,
        "model.stage2_rois": 64, "model.dtype": "float32",
        "model.nms_type_for_stage1": "soft_nms"})
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
            raise AssertionError(f"tiny f32 RRNet: {name} differ cuda vs cpu")
    torch.testing.assert_close(b.rois.cpu(), a.rois, atol=1e-3, rtol=0)
    torch.testing.assert_close(b.hms[-1].cpu(), a.hms[-1], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(b.stage2_reg.cpu(), a.stage2_reg, atol=1e-4,
                               rtol=1e-4)
    print(f"  tiny RRNet f32 cuda == cpu: {int(a.roi_valid.sum())} ROIs, "
          "classes/validity equal, boxes within 1e-3, heads within 1e-4",
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


def run_main_path(torch, sn, card):
    from rrnet_torch import config
    from rrnet_torch.models import build_model
    from rrnet_torch.models.rrnet import mask_heatmap_extent
    from rrnet_torch.ops.heatmap import topk_decode, topk_desc
    from rrnet_torch.serving import Predictor

    cfg = config.rrnet_config(**{"model.nms_type_for_stage1": "soft_nms"})
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    print(f"  model: {sum(p.numel() for p in model.parameters())} params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    pred = Predictor(cfg, model, device="cuda")

    forwards = []

    def hook(module, args, kwargs, out):
        forwards.append((out, kwargs.get("valid_hw")))

    handle = model.register_forward_hook(hook, with_kwargs=True)
    rng = np.random.RandomState(cfg.seed)
    sizes = [(765, 1360), (700, 1300), (768, 1408), (641, 1281),
             (720, 1350), (750, 1400), (690, 1290), (760, 1380)]
    images = [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in sizes]

    sn.launches = 0                               # every count to 0
    pred.warmup(((765, 1360),), batch_sizes=(1, 4))
    # single requests, twice over the same sizes: the first pass meets
    # each size for the first time. The Predictor's window then holds
    # single requests only; the batch goes on its own clock.
    passes = [[], []]
    outs = []
    for ms_list in passes:
        for im in images:
            t0 = time.perf_counter()
            outs.append(pred.predict(im))
            ms_list.append((time.perf_counter() - t0) * 1e3)
    stats = pred.latency_stats()
    t0 = time.perf_counter()
    batch = pred.predict_batch(images[:4])
    batch_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = sn.launches                        # read just after
    handle.remove()

    n_fwd = 2 + 2 * len(images) + 1
    if launches != len(forwards) or len(forwards) != n_fwd:
        raise AssertionError(f"soft_nms launches {launches} for "
                             f"{len(forwards)} forwards (want 1 each)")
    for d in outs + batch:
        check_detections(d, cfg.model.stage2_rois, cfg.num_classes)

    # one request's ROI selection again, with the plain soft-NMS
    out, vhw = forwards[5]                        # request sizes[3]
    m = model                                     # its stage-1 settings
    with torch.inference_mode():
        hm = mask_heatmap_extent(out.hms[-1].float(), vhw, 4)
        dets = topk_decode(hm, out.whs[-1].float(), out.offsets[-1].float(),
                           k=m.topk)
        ns, keep, _ = sn.soft_nms_reference(
            dets.boxes, dets.scores, None, dets.classes,
            sigma=m.soft_nms_sigma, iou_threshold=m.nms_iou,
            score_threshold=m.soft_nms_score_threshold, method="gaussian",
            max_out=m.stage2_rois)
        top, idx = topk_desc(torch.where(keep, ns, -torch.inf), m.stage2_rois)
        valid = top > -torch.inf
        rois = torch.gather(dets.boxes, 1, idx[..., None].expand(-1, -1, 4))
        if not (torch.equal(valid, out.roi_valid)
                and torch.equal(rois, out.rois)
                and torch.equal(torch.gather(dets.classes, 1, idx),
                                out.roi_classes)):
            raise AssertionError("main-path ROI selection differs from the "
                                 "plain soft-NMS")
        torch.testing.assert_close(torch.where(valid, top, 0.0),
                                   out.roi_scores, rtol=1e-5, atol=0)
    rows = [len(d) for d in outs[len(images):]]
    print(f"  served {len(outs)} single requests + 1 batch of 4 "
          f"({len(forwards)} forwards incl. warmup): rows per image {rows}; "
          f"request {sizes[3]} ROI selection == plain soft-NMS "
          f"({int(out.roi_valid.sum())} ROIs)", flush=True)
    p1, p2 = (np.percentile(p, [50, 90]) for p in passes)
    print(f"  single-request latency on {card}: Predictor window of "
          f"{stats['count']} requests p50 {stats['p50_s'] * 1e3:.2f} ms, "
          f"p90 {stats['p90_s'] * 1e3:.2f} ms; first pass p50 {p1[0]:.2f} "
          f"p90 {p1[1]:.2f} ms, second pass p50 {p2[0]:.2f} p90 {p2[1]:.2f} "
          f"ms; per request {[round(x, 2) for x in passes[0] + passes[1]]}",
          flush=True)
    print(f"  predict_batch of 4 on {card}: {batch_ms:.2f} ms", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from rrnet_torch.ops import soft_nms as sn
    from rrnet_torch.utils import native

    phase("device")
    card = card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          "allow_tf32 off for cuDNN and matmul", flush=True)

    phase("build")
    t0 = time.perf_counter()
    native.load("soft_nms")
    secs = time.perf_counter() - t0
    print(f"  kernels built in {secs:.1f} s", flush=True)
    for line in native.build_log("soft_nms"):
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    phase("kernels vs plain")
    rng = np.random.RandomState(0)
    soft = check_soft_nms(torch, sn, rng)

    phase("small-input reference")
    check_small_reference(torch)

    phase("main path")
    soft["launches"] = run_main_path(torch, sn, card)

    print(json.dumps({"kernels": [soft]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
