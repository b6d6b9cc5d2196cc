"""Trainer: the train step of RRNet, CenterNet and RetinaNet on one card
(port of `rrnet_tpu/train/trainer.py:33-217`).

    trainer = Trainer(cfg)                       # device="cuda"
    state = trainer.init_state(generator=...)
    state, metrics = trainer.train_step(state, batch)

`batch` keeps the JAX package's layout:
    images: (B, H, W, 3) uint8 RGB (train.transport='rgb'),
            (B, H, W, 3) float, already normalised,
            or (B, 1.5*H*W) uint8 packed YUV 4:2:0 rows;
    annos:  (B, N, 8) f32 VisDrone rows [x, y, w, h, score, cls, trunc,
            occ] in input pixels;
    valid:  (B, N) bool.
numpy arrays or tensors; they are moved to the trainer's device.

One step: normalise on the device, the model in train mode on the state
(`torch.func.functional_call`, batch statistics), the losses: for the
CenterNet family the targets rendered on the device and total = hm +
wh_weight * wh + off, plus for RRNet s2, gated off for the first
`train.stage2_warmup_steps` steps; for RetinaNet the anchors of the crop
size (computed once, a device constant) assigned by IoU and total = cls +
reg. Then the
gradients, then the fused Adam with the exact skip: a non-finite total
leaves params, moments, counts, step and BN running statistics as they
were (the reference skips a step on CUDA OOM, rrnet_operator.py:120-126),
and non-finite gradients are zeroed first.

Data parallelism (the JAX step's `shard_map` over the `data` axis):
`Trainer(cfg, device, group=parallel.DataGroup)` runs one rank of a
world of W, each rank on its own share of the global batch. The model's
batch norms are SyncBN over the group where `model.sync_bn` is set (RRNet
and `rrnet_hrnetv2_attention`; CenterNet and RetinaNet keep each rank's
own statistics, as each JAX device keeps its own shard's), the flat f32
gradient is averaged over the ranks in one collective, the skip flag is
`mean(isfinite(total)) >= 1` over the ranks (one rank's non-finite loss
skips every rank), and the logged metrics are averaged as one stacked
tensor. Params, moments, counts and step stay bitwise equal on every
rank; rank 0's state is the one to save. With no group, or a world of
one, no collective is issued and the step is the single-card step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from rrnet_torch.config import Config
from rrnet_torch.data.yuv420 import unpack_yuv420_device
from rrnet_torch.models import build_model
from rrnet_torch.models.anchors import model_anchors
from rrnet_torch.parallel import DataGroup, all_mean, all_mean_, replicate
from rrnet_torch.train import criterions
from rrnet_torch.train.state import TrainState, create_train_state, views
from rrnet_torch.utils.device import resolve_device


class Trainer:
    """Builds the model (in train mode) and runs the train step on
    `device` ("cuda" unless the caller asks for the CPU), as one rank of
    the data-parallel `group` where one is given."""

    def __init__(self, cfg: Config,
                 device: Union[str, torch.device] = "cuda",
                 group: Optional[DataGroup] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        self.model = build_model(cfg, device=self.device,
                                 group=group).train()
        ch, cw = cfg.train.crop_size
        s = cfg.train.scale_factor
        self.feat_shape = (ch // s, cw // s)
        self.mean = torch.tensor(cfg.train.mean, dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(cfg.train.std, dtype=torch.float32,
                                device=self.device)
        self.anchors = None
        if cfg.model.name == "retinanet":
            self.anchors = torch.tensor(
                model_anchors(cfg.model, cfg.train.crop_size),
                device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """Weights drawn on the CPU from `generator` (default: seeded with
        cfg.seed, the weights the model was built with), zero moments and
        counts; with a group, rank 0's state broadcast to every rank."""
        src = self.model if generator is None else build_model(
            self.cfg, device="cpu", generator=generator)
        state = create_train_state(self.cfg, src, device=self.device)
        replicate(state.tensors().values(), self.group)
        return state

    # ------------------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device, non_blocking=True)

    def normalise(self, images) -> torch.Tensor:
        """The batch's images as the model's (B, 3, H, W) f32 input."""
        x = self._to_device(images)
        if x.dim() == 2:
            ch, cw = self.cfg.train.crop_size
            x = unpack_yuv420_device(x, ch, cw) / 255.0
            x = (x - self.mean) / self.std
        elif x.dtype == torch.uint8:
            x = (x.float() / 255.0 - self.mean) / self.std
        return x.permute(0, 3, 1, 2).contiguous()

    def _losses(self, outs, annos, valid, step) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        if cfg.model.name == "retinanet":
            loc, cls = outs
            m = cfg.model
            ld = criterions.retinanet_criterion(
                loc, cls, annos, valid, self.anchors,
                pos_iou=m.retina_pos_iou, neg_iou=m.retina_neg_iou,
                alpha=m.retina_alpha, gamma=m.retina_gamma)
            return ld["cls"] + ld["reg"], ld
        targets = criterions.centernet_targets(
            annos, valid, self.feat_shape, cfg.train.scale_factor,
            cfg.num_classes)
        if cfg.model.name == "centernet":
            hms, whs, offs = outs
            ld = criterions.centernet_criterion(hms, whs, offs, targets)
            total = ld["hm"] + cfg.train.wh_weight * ld["wh"] + ld["off"]
            return total, ld
        ld = criterions.centernet_criterion(outs.hms, outs.whs,
                                            outs.offsets, targets)
        s2 = criterions.rrnet_stage2_criterion(outs, annos, valid,
                                               cfg.train.scale_factor)
        # stage 2 gated off for the first N steps (rrnet_operator.py:132)
        s2_factor = torch.where(step < cfg.train.stage2_warmup_steps,
                                0.0, 1.0)
        ld = dict(ld, s2=s2)
        total = (ld["hm"] + cfg.train.wh_weight * ld["wh"] + ld["off"]
                 + s2 * s2_factor)
        return total, ld

    def _value_grads(self, state: TrainState, batch):
        """Forward on the state (BN statistics updated in place), losses
        and the flat f32 gradient, averaged over the group's ranks."""
        images = self.normalise(batch["images"])
        annos = self._to_device(batch["annos"]).float()
        valid = self._to_device(batch["valid"]).bool()
        leaves = {k: v.detach().requires_grad_()
                  for k, v in state.params().items()}
        outs = functional_call(self.model, (leaves, state.batch_stats()),
                               (images,), strict=True)
        total, ld = self._losses(outs, annos, valid, state.step)
        grads = torch.autograd.grad(total, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
        flat = all_mean_(torch.cat([g.reshape(-1).float() for g in grads]),
                         self.group)
        return total.detach(), flat, {k: v.detach() for k, v in ld.items()}

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update, IN PLACE on `state` (returned). metrics: hm, wh,
        off and (RRNet) s2, or (RetinaNet) cls and reg; total and
        skipped; 0-dim f32 tensors on the device."""
        old_stats = state.flat_stats.clone()
        total, grads, ld = self._value_grads(state, batch)
        # one rank's non-finite loss skips the step on every rank
        good = all_mean(torch.isfinite(total).to(torch.float32),
                        self.group) >= 1.0
        names = [*ld, "total"]
        means = all_mean(torch.stack([*ld.values(), total]), self.group)
        metrics = dict(zip(names, means.unbind(0)),
                       skipped=1.0 - good.to(torch.float32))
        # poisoned grads must not give NaN * 0 in the fused update
        grads = torch.where(torch.isfinite(grads), grads, 0.0)
        state.apply_gradients(grads, good=good, old_batch_stats=old_stats)
        return state, metrics

    def loss_and_grads(self, state: TrainState, batch
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The total loss and the gradients ({parameter name: tensor}),
        both averaged over the group's ranks, without applying the update;
        the state, its BN statistics included, is left as it was."""
        old_stats = state.flat_stats.clone()
        total, grads, _ = self._value_grads(state, batch)
        state.flat_stats.copy_(old_stats)
        return all_mean(total, self.group), views(grads, state.layout.params)
