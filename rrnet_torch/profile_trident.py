"""Where the trident backbone's time goes on the card.

    python -m rrnet_torch.profile_trident [--iters N] [--tf32]

Builds `trires50deform` at full width in f32 with seeded weights and
nonzero offset/mask convs (`path_model`, as `chip_smoke.py` drives it) and
prints, for the serve forward at 1x3x768x1408 (eval) and
the train step at 4x3x512x512 (train-mode BN, backward of a seeded
loss), as medians over N iterations:
  * wall time per iteration without the profiler (host clock around
    work that ends in a synchronize);
  * kernel time per iteration from `torch.profiler`, the DCN kernels'
    share of it (each DCN kernel apart: the forward, the backward's data
    and weight kernels), and the device's busy share of the unprofiled
    wall time;
  * the busiest kernels.
The port runs its f32 convolutions at f32 precision whatever PyTorch's
TF32 setting (`models.layers.conv2d`); `--tf32` lifts that pin for this
run, so that cuDNN takes TF32 at PyTorch's default, for a comparison of
the two precisions. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from rrnet_torch.models import build_backbone, layers

SERVE_SHAPE = (1, 3, 768, 1408)
TRAIN_SHAPE = (4, 3, 512, 512)


def path_model(seed: int = 7, device: str = "cuda"):
    """`trires50deform` from `seed`, with the zero-initialised offset/mask
    convs redrawn (weights N(0, 0.01), biases N(0, 0.1)) so that the
    deformable samples leave the integer grid."""
    gen = torch.Generator().manual_seed(seed)
    model = build_backbone("trires50deform", device=device, generator=gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "offset_mask" in name:
                std = 0.01 if name.endswith("weight") else 0.1
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model


def train_cotangents(seed: int = 7, device: str = "cuda"):
    """Seeded cotangents of l1..l4 at the train shape; the loss is
    sum_i <l_i, ct_i> / numel(l_i)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=device) for s in
            ((4, 256, 128, 128), (4, 512, 64, 64), (12, 1024, 32, 32),
             (12, 2048, 32, 32))]


def _profile(fn, n):
    """(kernel ms per call, {kernel name: (ms per call, calls per call)})
    under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows[e.key] = (e.self_device_time_total / 1e3 / n, e.count / n)
    return sum(ms for ms, _ in rows.values()), rows


def _wall_ms(fn, n):
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def kernel_name(key: str) -> str:
    """`(anonymous namespace)::dcn_fwd_kernel(float const*, ...)` ->
    `dcn_fwd_kernel`"""
    return key.replace("(anonymous namespace)::", "").split("(")[0]


def _report(name, wall, kernel_ms, rows):
    p50 = float(np.median(wall))
    dcn = {kernel_name(k): v for k, v in rows.items() if "dcn_" in k}
    dcn_ms = sum(ms for ms, _ in dcn.values())
    print(f"{name}: wall p50 {p50:.2f} ms (min {min(wall):.2f}, max "
          f"{max(wall):.2f}); kernels {kernel_ms:.2f} ms, device busy "
          f"{100 * kernel_ms / p50:.1f}% of the wall time; DCN kernels "
          f"{dcn_ms:.2f} ms ({100 * dcn_ms / kernel_ms:.1f}% of the kernel "
          "time): " + ", ".join(f"{k} {ms:.2f} ms x{c:g} ({ms / c:.4f} ms "
                                f"each)" for k, (ms, c) in sorted(dcn.items())))
    for k, (ms, c) in sorted(rows.items(), key=lambda r: -r[1][0])[:12]:
        print(f"  {ms:8.3f} ms  x{c:<5g} {k[:100]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tf32", action="store_true",
                    help="let cuDNN run the f32 convolutions in TF32 "
                         "(PyTorch's default) instead of the port's f32 pin")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_trident needs a CUDA device")
    if args.tf32:
        layers.cudnn_f32 = contextlib.nullcontext
    n = args.iters
    model = path_model()
    rng = np.random.RandomState(7)
    x_serve = torch.from_numpy(rng.randn(*SERVE_SHAPE).astype(np.float32)
                               ).cuda()
    x_train = torch.from_numpy(rng.randn(*TRAIN_SHAPE).astype(np.float32)
                               ).cuda()
    cts = train_cotangents()

    def serve():
        with torch.no_grad():
            model.eval()(x_serve)

    def train_step():
        model.train()
        model.zero_grad(set_to_none=True)
        outs = model(x_train)
        sum((o * c).sum() / o.numel() for o, c in zip(outs, cts)).backward()

    precision = ("TF32 convolutions (PyTorch's default)" if args.tf32 else
                 "f32 convolutions (the port's pin)")
    print(f"{torch.cuda.get_device_name(0)}; trires50deform f32, "
          f"{precision}; medians over {n} iterations after 2 warm-ups")
    for name, fn in (("serve forward 1x3x768x1408", serve),
                     ("train step 4x3x512x512", train_step)):
        _wall_ms(fn, 2)
        wall = _wall_ms(fn, n)
        kernel_ms, rows = _profile(fn, n)
        _report(name, wall, kernel_ms, rows)


if __name__ == "__main__":
    main()
