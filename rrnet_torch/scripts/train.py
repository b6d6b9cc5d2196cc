"""Training entry point (port of `scripts/train.py`):

    python -m rrnet_torch.scripts.train --config rrnet [--steps N]
        [--resume DIR] [--device cuda|cpu] [--multihost] [key=value ...]

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
from typing import Optional, Sequence

import torch.distributed as dist

from rrnet_torch import config as cfglib
from rrnet_torch.data.loader import DevicePrefetcher, TrainLoader
from rrnet_torch.parallel import create_group, init_from_env
from rrnet_torch.train import Trainer
from rrnet_torch.utils import checkpoint as ckpt
from rrnet_torch.utils.logger import Logger


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
                logger.log({"scalar": {
                    f"train/{k}_loss" if k != "total" else "train/total_loss":
                    v / len(running) for k, v in sums.items()}}, step)
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
