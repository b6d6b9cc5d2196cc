"""Where a train step's time goes on the card.

    python -m rrnet_torch.profile_train [--iters N]
        [--config rrnet|retinanet|rrnet_hrnetv2_attention]

Builds `train.Trainer` on the `rrnet` preset at full width (hourglass-104,
2 stacks, bf16 compute, f32 parameters and Adam state, the preset's
stage-1 hard NMS, stage 2 from step 0), on the `rrnet_hrnetv2_attention`
preset likewise (HRNetV2-w40 with frozen BN statistics, the attention on
both stacks), or on the `retinanet` preset (`--config retinanet`:
ResNet-50, FPN-256, the two towers, bf16), with
seeded weights, and one seeded synthetic batch of 4 uint8 512x512 crops
with 100-250 boxes each (`synthetic_batch`, as `chip_smoke.py` drives
it). It prints, as medians over N steps after 2 warm-ups:
  * wall time per step without the profiler (host clock around a step
    that ends in a synchronize), and the peak device memory;
  * the device span of each phase, from CUDA events: the forward and, in
    it, the backbone, the heads (RRNet: the attention modules where the
    preset has them and the stage-1 heads, the rest being decode, NMS,
    ROI-align and stage 2; RetinaNet: the FPN and the two
    towers over their three levels); the targets and losses; the
    backward with the gradient flatten; the Adam update;
  * kernel time per step from `torch.profiler`, the device's busy share
    of the unprofiled wall time, the NMS kernels' time, and the busiest
    kernels.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from rrnet_torch import config


def train_config(name: str = "rrnet"):
    """The preset as the train path runs it: its defaults, and for RRNet
    stage 2 on from the first step (the one cut, so that its loss and
    gradient run within a few steps)."""
    if name == "retinanet":
        return config.retinanet_config()
    return config.PRESETS[name](**{"train.stage2_warmup_steps": 0})


def synthetic_batch(rng: np.random.RandomState, b: int = 4,
                    hw=(512, 512), max_objects: int = 320,
                    n_valid=(100, 250), size=(4.0, 64.0)):
    """A drone-like batch in the Trainer's layout: uint8 RGB crops, and
    per crop n_valid[0]..n_valid[1] valid VisDrone rows of boxes `size`
    px on a side (log-uniform), classes 1..10, padded to max_objects."""
    h, w = hw
    images = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    annos = np.zeros((b, max_objects, 8), np.float32)
    valid = np.zeros((b, max_objects), bool)
    for i in range(b):
        n = rng.randint(n_valid[0], n_valid[1] + 1)
        wh = np.exp(rng.uniform(np.log(size[0]), np.log(size[1]), (n, 2)))
        xy = rng.rand(n, 2) * (np.array([w, h]) - wh)
        annos[i, :n, :2] = xy
        annos[i, :n, 2:4] = wh
        annos[i, :n, 4] = 1.0
        annos[i, :n, 5] = rng.randint(1, 11, n)
        valid[i, :n] = True
    return {"images": images, "annos": annos, "valid": valid}


class _Spans:
    """CUDA event pairs around named parts of a step."""

    def __init__(self):
        self.events = {}

    def start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.setdefault(name, []).append([ev, None])

    def stop(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name][-1][1] = ev

    def wrap(self, name, fn):
        def timed(*a, **kw):
            self.start(name)
            out = fn(*a, **kw)
            self.stop(name)
            return out
        return timed

    def hook(self, name, module):
        return [module.register_forward_pre_hook(
                    lambda *_: self.start(name)),
                module.register_forward_hook(lambda *_: self.stop(name))]

    def medians(self, n):
        """Per part, the median over `n` steps of its span summed over
        the step (a head runs once a stack or a level)."""
        return {k: float(np.median(np.reshape(
            [a.elapsed_time(b) for a, b in v], (n, -1)).sum(1)))
            for k, v in self.events.items()}


def main(argv=None) -> None:
    from rrnet_torch.train import Trainer
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--config", choices=("rrnet", "retinanet",
                                         "rrnet_hrnetv2_attention"),
                    default="rrnet")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    n = args.iters
    cfg = train_config(args.config)
    retina = args.config == "retinanet"
    heads = ("fpn", "cls", "loc") if retina else ("hm", "wh", "offset")
    if cfg.model.with_self_attention:
        heads = ("attention0", "attention1") + heads
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(generator=torch.Generator().manual_seed(
        cfg.seed))
    batch = synthetic_batch(np.random.RandomState(cfg.seed))

    def step():
        trainer.train_step(state, batch)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    spans = _Spans()
    m = trainer.model
    handles = spans.hook("forward", m) + spans.hook("backbone", m.backbone)
    for k in heads:
        handles += spans.hook(k, getattr(m, k))
    losses = trainer._losses
    trainer._losses = spans.wrap("targets+losses", losses)
    update = state.apply_gradients
    state.apply_gradients = spans.wrap("update", update)
    spans_step = spans.wrap("step", step)
    for _ in range(n):
        spans_step()
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    trainer._losses = losses
    del state.apply_gradients
    ms = spans.medians(n)
    # the backward: from the end of the losses to the start of the update
    back = [a[1].elapsed_time(b[0]) for a, b in
            zip(spans.events["targets+losses"], spans.events["update"])]

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = (e.self_device_time_total / 1e3 / n, e.count / n)
    kernel_ms = sum(v for v, _ in rows.values())
    nms = {k: v for k, v in rows.items() if "nms_" in k}
    p50 = float(np.median(wall))
    head_ms = sum(ms[k] for k in heads)
    what = ("retinanet preset, bf16" if retina else
            f"{args.config} preset, bf16, {cfg.model.nms_type_for_stage1} "
            "stage 1")
    print(f"{torch.cuda.get_device_name(0)}; {what}, batch 4x512x512, "
          f"{int(batch['valid'].sum())} boxes; medians over {n} steps after "
          "2 warm-ups, ms")
    print(f"step wall p50 {p50:.2f} (min {min(wall):.2f}, max "
          f"{max(wall):.2f}); peak memory {peak / 2**30:.2f} GiB")
    rest = ms["forward"] - ms["backbone"] - head_ms
    parts = (", ".join(f"{k} {ms[k]:.2f}" for k in heads)
             + (f", the rest {rest:.2f}" if retina else
                f"; decode+NMS+ROI-align+stage 2 {rest:.2f}"))
    print(f"device span: step {ms['step']:.2f}; forward {ms['forward']:.2f} "
          f"(backbone {ms['backbone']:.2f}, {parts}); targets+losses "
          f"{ms['targets+losses']:.2f}; backward {float(np.median(back)):.2f};"
          f" update {ms['update']:.2f}")
    print(f"kernels per step {kernel_ms:.2f}: device busy "
          f"{100 * kernel_ms / p50:.1f}% of the wall time; NMS kernels "
          + ", ".join(f"{k.split('<')[0]} {v:.3f} x{c:g}"
                      for k, (v, c) in nms.items()))
    for k, (v, c) in sorted(rows.items(), key=lambda r: -r[1][0])[:15]:
        print(f"  {v:8.3f} ms  x{c:<6g} {k[:100]}")


if __name__ == "__main__":
    main()
