"""Training entry point (port of `scripts/train.py`):

    python -m rrnet_torch.scripts.train --config rrnet [--steps N]
        [--resume DIR] [--device cuda|cpu] [--multihost] [--log-images]
        [key=value ...]

e.g. `python -m rrnet_torch.scripts.train data_root=/data/VisDrone
train.lr=1e-4`. Batches come from `data.loader.TrainLoader` through a
`DevicePrefetcher`, steps from `train.Trainer`. Losses stay on the device
until `train.print_interval`, when their means are logged (a float per
step would sync the host with the card every step). A checkpoint is
written to `{log_dir}/{log_prefix}/ckp-{step}` every
`train.checkpoint_interval` steps and at the end; `--resume` restores
the newest under a directory (or a `ckp-N` path) and goes on from its
step, with the loader at the sample an uninterrupted run would draw
next. One process on one card (or the CPU, for tests).

`--log-images` adds, at each `print_interval`, the first image of the
batch drawn twice (`utils.vis.visualize`) to the log under `imgs`: with
the model's top-100 stage-1 detections above score 0.25 and with the
ground truth, as RGB float images in [0, 1] (the reference's
TensorBoard images). Only `rrnet` and `centernet` draw; other families
log none.

`--multihost` trains data-parallel, one process a rank, as `torchrun`
starts them:

    torchrun --nproc-per-node N -m rrnet_torch.scripts.train --multihost ...

Each rank joins the process group from the environment
(`parallel.init_from_env`: NCCL on `cuda:LOCAL_RANK`, gloo with
`--device cpu`), reads its own shard of the split (`TrainLoader
(process_index=rank, process_count=world)`) at `train.batch_size` a rank,
so the global batch is `train.batch_size` times the world size (the LR
is not scaled, as in the JAX package), and steps through a `Trainer` on
the group. Only rank 0 logs and writes checkpoints; `--resume` restores
on every rank.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import DevicePrefetcher, TrainLoader
from rrnet_torch.data.transforms import denormalize
from rrnet_torch.data.yuv420 import yuv420_to_rgb_host
from rrnet_torch.ops.heatmap import topk_decode
from rrnet_torch.parallel import create_group, init_from_env
from rrnet_torch.train import Trainer
from rrnet_torch.utils import checkpoint as ckpt
from rrnet_torch.utils.logger import Logger
from rrnet_torch.utils.vis import visualize


def visualize_batch(trainer: Trainer, state, batch, cfg) -> List[np.ndarray]:
    """The first image of `batch` with the state's predictions (eval
    form: running BN statistics) and with its ground truth, as float
    (H + 14, W, 3) images in [0, 1]; [] for a family without a heatmap
    (the JAX train script's `_visualize_batch`, reference
    operators/centernet_operator.py:120-141)."""
    if cfg.model.name not in ("rrnet", "centernet"):
        return []
    img = np.asarray(torch.as_tensor(batch["images"])[0:1].cpu())
    if img.ndim == 2:       # packed YUV 4:2:0 rows (train.transport)
        h, w = cfg.train.crop_size
        q = h * w // 4
        y = img[:, :h * w].reshape(1, h, w)
        uv = np.stack([img[:, h * w:h * w + q].reshape(1, h // 2, w // 2),
                       img[:, h * w + q:].reshape(1, h // 2, w // 2)], -1)
        img = yuv420_to_rgb_host(y, uv)
    base = (img[0] if img.dtype == np.uint8 else
            (np.clip(denormalize(img[0], cfg.train.mean, cfg.train.std),
                     0, 1) * 255).astype(np.uint8))
    model = trainer.model
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            outs = functional_call(model, state.state_dict(),
                                   (trainer.normalise(img),))
    finally:
        model.train(was_training)
    if cfg.model.name == "rrnet":
        hm, wh, off = outs.hms[-1], outs.whs[-1], outs.offsets[-1]
    else:
        hm, wh, off = outs[0][-1], outs[1][-1], outs[2][-1]
    dets = topk_decode(hm.float(), wh.float(), off.float(), k=100,
                       scale_factor=float(cfg.train.scale_factor))
    boxes = dets.boxes[0].cpu().numpy()
    scores = dets.scores[0].cpu().numpy()
    classes = dets.classes[0].cpu().numpy() + 1
    keep = scores > 0.25
    rows = np.concatenate([boxes[keep, :2], boxes[keep, 2:4] - boxes[keep, :2],
                           scores[keep, None], classes[keep, None]], axis=1)
    gt = (np.asarray(torch.as_tensor(batch["annos"])[0].cpu())
          [np.asarray(torch.as_tensor(batch["valid"])[0].cpu())])
    return [visualize(base, rows, with_score=True).astype(np.float32) / 255.0,
            visualize(base, gt[:, :6]).astype(np.float32) / 255.0]


def main(argv: Optional[Sequence[str]] = None) -> Optional[str]:
    """Run the training loop; returns the path of the last checkpoint
    (None on ranks other than 0)."""
    ap = argparse.ArgumentParser(
        prog="python -m rrnet_torch.scripts.train",
        description="Train a preset on one card, or as one rank of a "
        "data-parallel torchrun launch.")
    ap.add_argument("--config", default="rrnet", choices=sorted(cfglib.PRESETS))
    ap.add_argument("--steps", type=int, default=None,
                    help="override train.iter_num")
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir or ckp-N path to resume from")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--multihost", action="store_true",
                    help="one data-parallel rank of a torchrun launch")
    ap.add_argument("--log-images", action="store_true",
                    help="log prediction and ground-truth drawings at "
                    "print_interval")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args(argv)

    cfg = cfglib.PRESETS[args.config]()
    cfg = cfglib.apply_overrides(cfg, args.overrides)
    if args.steps is not None:
        cfg = cfglib.set_by_path(cfg, "train.iter_num", args.steps)

    group, device = None, args.device
    if args.multihost:
        device = init_from_env(args.device)
        group = create_group(cfg.mesh, device)
    try:
        return _train(cfg, args, device, group)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _train(cfg, args, device, group) -> Optional[str]:
    rank, world = (group.rank, group.world_size) if group else (0, 1)
    main_proc = rank == 0
    logger = Logger(cfg, main_process=main_proc)
    logger.init_timer(cfg.train.iter_num)
    trainer = Trainer(cfg, device=device, group=group)
    state = trainer.init_state()
    if args.resume:
        state = ckpt.restore_checkpoint(args.resume, state)
        print(f"resumed from step {int(state.step)}", flush=True)
    start = int(state.step)
    batch_size = cfg.train.batch_size
    loader = DevicePrefetcher(
        TrainLoader(cfg, batch_size, process_index=rank, process_count=world,
                    start_sample=start * batch_size),
        device=trainer.device)

    path = None
    running = []   # metric dicts of device tensors, read at print time
    try:
        for step in range(start, cfg.train.iter_num):
            batch = loader.get_batch()
            state, metrics = trainer.train_step(state, batch)
            if not main_proc:
                continue
            running.append(metrics)
            if step % cfg.train.print_interval == \
                    cfg.train.print_interval - 1:
                sums = {}
                for m in running:
                    for k, v in m.items():
                        sums[k] = sums.get(k, 0.0) + float(v)
                log_data = {"scalar": {
                    f"train/{k}_loss" if k != "total" else "train/total_loss":
                    v / len(running) for k, v in sums.items()}}
                if args.log_images:
                    log_data["imgs"] = {"train": visualize_batch(
                        trainer, state, batch, cfg)}
                logger.log(log_data, step)
                running = []
            if (step % cfg.train.checkpoint_interval ==
                    cfg.train.checkpoint_interval - 1
                    or step == cfg.train.iter_num - 1):
                path = ckpt.save_checkpoint(logger.log_dir, state)
                print(f"saved {path}", flush=True)
    finally:
        loader.close()
        logger.close()
    return path


if __name__ == "__main__":
    main()
