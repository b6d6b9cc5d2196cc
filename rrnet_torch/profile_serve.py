"""Where a Predictor request's time goes on the card.

    python -m rrnet_torch.profile_serve [--requests N] [--nms TYPE]
        [--config rrnet|retinanet|rrnet_hrnetv2_attention]

Serves the flagship `rrnet` preset (full width, bf16, seeded random
weights) with its stage-1 NMS, hard NMS by default or `--nms soft_nms`,
the `rrnet_hrnetv2_attention` preset likewise, or the `retinanet` preset
(`--config retinanet`; its decode and hard NMS run after the model's
forward), on one 765x1360 image at a time, as `chip_smoke.py` does, and
prints the forward's multiply-adds by part at 768x1408
(`forward_gmacs`), then, as medians over N requests:
  * request latency without the profiler, and host staging (pad, pack,
    pinned upload);
  * the device span of the forward and of its parts, from CUDA events
    around them (RRNet: the backbone, the attention modules where the
    preset has them, the stage-1 heads and the stage-2 head, the rest of
    the forward being decode, NMS and ROI-align;
    RetinaNet: the backbone, the FPN and the two towers over their three
    levels, and apart from the forward its decode + NMS), and the host
    time to issue the forward;
  * kernel time per request and per bare forward, from `torch.profiler`:
    the device's busy share of the unprofiled latency, and the gaps
    between kernels inside the forward;
  * the busiest kernels of a request.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rrnet_torch import config
from rrnet_torch.models import build_model
from rrnet_torch.serving import Predictor


def _part_timers(model, names):
    """CUDA event pairs around the forward and each of its submodules
    `names`, and the host's perf_counter around the whole forward."""
    parts = {"forward": model, **{k: getattr(model, k) for k in names}}
    events = {k: [] for k in parts}
    host = []
    handles = []
    for name, mod in parts.items():
        def pre(_m, _a, name=name):
            if name == "forward":
                host.append(time.perf_counter())
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev
            if name == "forward":
                host[-1] = time.perf_counter() - host[-1]

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return events, host, handles


def forward_gmacs(cfg, hw=(768, 1408)) -> dict:
    """Multiply-adds (G) of one image's forward at `hw` by part, counted
    by `torch.utils.flop_counter.FlopCounterMode` on meta tensors (no
    device): RRNet's backbone, attention, stage-1 heads and stage 2 at
    its full ROI budget (decode and NMS are not counted), or RetinaNet's
    backbone, FPN and towers."""
    from torch.utils.flop_counter import FlopCounterMode
    model = build_model(cfg, device="cpu").float().to("meta")
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    out = {}

    def count(name, fn):
        with FlopCounterMode(display=False) as fc:
            res = fn()
        out[name] = out.get(name, 0.0) + fc.get_total_flops() / 2e9
        return res

    x = torch.empty(1, 3, *hw, device="meta")
    feats = count("backbone", lambda: model.backbone(x))
    if cfg.model.name == "retinanet":
        ps = count("fpn", lambda: model.fpn(*feats[1:]))
        for p in ps:
            count("towers", lambda: (model.cls(p), model.loc(p)))
        return out
    for i in range(cfg.model.num_stacks):
        f = torch.relu(feats[i])
        if getattr(model, "with_attention", False):
            f = count("attention", lambda: f + getattr(model,
                                                       f"attention{i}")(f))
        count("heads", lambda: (model.hm(f, i), model.wh(f, i),
                                model.offset(f, i)))
    c = feats[-1].shape[1]
    rois = torch.empty(cfg.model.stage2_rois, c, 3, 3, device="meta")
    count("stage2", lambda: model.head_detector(rois))
    return out


def _kernel_ms(fn, n):
    """Device kernel time per call of `fn` under torch.profiler, and the
    profiler's averages."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    # kernel rows only: an operator row's device time repeats its kernels'
    us = sum(e.self_device_time_total for e in avg
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / n, avg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--nms", choices=("nms", "soft_nms"),
                    default=config.rrnet_config().model.nms_type_for_stage1,
                    help="RRNet's stage-1 NMS (default: the preset's)")
    ap.add_argument("--config", choices=("rrnet", "retinanet",
                                         "rrnet_hrnetv2_attention"),
                    default="rrnet")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")

    retina = args.config == "retinanet"
    if retina:
        cfg = config.retinanet_config()
        names = ("backbone", "fpn", "cls", "loc")
    else:
        cfg = config.PRESETS[args.config](
            **{"model.nms_type_for_stage1": args.nms})
        names = ("backbone", "hm", "wh", "offset", "head_detector")
        if cfg.model.with_self_attention:
            names = ("backbone", "attention0", "attention1") + names[1:]
    macs = forward_gmacs(cfg)
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator().manual_seed(cfg.seed))
    pred = Predictor(cfg, model, device="cuda")
    pred.warmup()
    img = (np.random.RandomState(0).rand(765, 1360, 3) * 255).astype(np.uint8)
    n = args.requests

    stage_s = []
    for _ in range(n):
        t0 = time.perf_counter()
        pred.stage([img])
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)

    events, host_fwd, handles = _part_timers(model, names)
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        pred.predict(img)
        lat.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    # a part called several times a forward (RetinaNet's towers, once a
    # level) is summed per forward before the median
    part_ms = {k: float(np.median(np.reshape(
        [a.elapsed_time(b) for a, b in v], (n, -1)).sum(1)))
        for k, v in events.items()}
    rest = part_ms["forward"] - sum(part_ms[k] for k in names)
    lat_ms = float(np.median(lat)) * 1e3
    stage_ms = float(np.median(stage_s)) * 1e3
    span = part_ms["forward"]

    req_kernel_ms, avg = _kernel_ms(lambda: pred.predict(img), n)
    # the bare forward on the inputs a request gives it
    inputs = []
    grab = model.register_forward_pre_hook(
        lambda _m, a, kw: inputs.append((a, kw)), with_kwargs=True)
    pred.predict(img)
    grab.remove()
    fwd_args, fwd_kwargs = inputs[0]
    with torch.inference_mode():
        fwd_kernel_ms, _ = _kernel_ms(lambda: model(*fwd_args, **fwd_kwargs), n)
    if retina:
        decode_ms = _decode_ms(pred, model, fwd_args[0], n)

    what = "retinanet" if retina else f"{args.config}, stage-1 {args.nms}"
    print(f"{torch.cuda.get_device_name(0)}; {n} requests of 765x1360, "
          f"{what}, transport {cfg.val.transport}; medians in ms")
    print("forward GMACs at 768x1408 (FlopCounterMode, meta): "
          + ", ".join(f"{k} {v:.2f}" for k, v in macs.items())
          + f"; total {sum(macs.values()):.2f}")
    print(f"request latency (no profiler): p50 {lat_ms:.2f}, p90 "
          f"{float(np.percentile(lat, 90)) * 1e3:.2f}, min "
          f"{min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}")
    print(f"outside the forward: {lat_ms - span:.2f} (latency - forward "
          f"span), of which host staging {stage_ms:.2f}, the rest "
          f"(device preprocess, result copy, host sort) "
          f"{lat_ms - span - stage_ms:.2f}")
    print(f"forward: device span {span:.2f}, kernels {fwd_kernel_ms:.2f}, "
          f"gaps between kernels {span - fwd_kernel_ms:.2f}; host time to "
          f"issue it {float(np.median(host_fwd)) * 1e3:.2f}")
    print("device span per part: " + ", ".join(
        f"{k} {v:.2f}" for k, v in part_ms.items() if k != "forward")
        + (f"; the rest of the forward (flatten, concat) {rest:.2f}; "
           f"decode + hard NMS after it {decode_ms:.2f}" if retina else
           f"; decode+NMS+ROI-align {rest:.2f}"))
    print(f"kernels per request {req_kernel_ms:.2f}: device busy "
          f"{100 * req_kernel_ms / lat_ms:.1f}% of the unprofiled latency")
    print(avg.table(sort_by="self_device_time_total", row_limit=25,
                    max_name_column_width=60))


def _decode_ms(pred, model, x, n):
    """Median device span of RetinaNet's decode + hard NMS, run as a
    request runs it on the forward's own outputs (CUDA events)."""
    from rrnet_torch.models import retinanet
    ev = pred._ev
    vhw = torch.tensor([[765, 1360]], dtype=torch.int32, device=x.device)
    anchors = ev.anchors_for(tuple(x.shape[-2:]))
    topk = min(4 * ev.decode_topk, anchors.shape[0])
    spans = []
    with torch.inference_mode():
        loc, cls = model(x)
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            retinanet.decode(loc, cls, anchors, vhw, topk)
            b.record()
            torch.cuda.synchronize()
            spans.append(a.elapsed_time(b))
    return float(np.median(spans))


if __name__ == "__main__":
    main()
