"""Train state and the fused, skip-aware Adam (port of
`rrnet_tpu/train/state.py:24-161`).

The state is the parameters, the BN running statistics, both Adam moments,
Adam's count, the schedule's count and the step: everything a resumed run
needs (`utils.checkpoint` saves all of it). Parameters, moments and
statistics each live in ONE flat f32 tensor on the device; `params()` and
`batch_stats()` give per-name views into them in the model's
`named_parameters()` / `named_buffers()` order, so the model runs on the
state through `torch.func.functional_call` and the update is a handful of
elementwise kernels over the flat tensors. The counts are 0-dim int64
device tensors, so a skipped step needs no trip to the host.

`apply_gradients` updates the state IN PLACE (the JAX package donates the
old state to the step; here nothing is copied) and returns it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from rrnet_torch.config import Config
from rrnet_torch.train.schedule import multistep_lr


@dataclass(frozen=True)
class Layout:
    """Names and shapes of the flat tensors' pieces, in order."""
    params: Tuple[Tuple[str, Tuple[int, ...]], ...]
    stats: Tuple[Tuple[str, Tuple[int, ...]], ...]

    @classmethod
    def of(cls, model: nn.Module) -> "Layout":
        return cls(tuple((k, tuple(p.shape))
                         for k, p in model.named_parameters()),
                   tuple((k, tuple(b.shape))
                         for k, b in model.named_buffers()))


def views(flat: torch.Tensor,
          pieces: Tuple[Tuple[str, Tuple[int, ...]], ...]
          ) -> Dict[str, torch.Tensor]:
    """Per-name views of the flat tensor `flat` laid out as `pieces`."""
    out, at = {}, 0
    for name, shape in pieces:
        n = 1
        for d in shape:
            n *= d
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _flat(tensors: Mapping[str, torch.Tensor],
          pieces: Tuple[Tuple[str, Tuple[int, ...]], ...],
          device) -> torch.Tensor:
    if not pieces:
        return torch.zeros(0, dtype=torch.float32, device=device)
    return torch.cat([tensors[k].detach().reshape(-1).to(device,
                                                         torch.float32)
                      for k, _ in pieces])


def make_schedule(cfg: Config) -> Callable:
    return multistep_lr(cfg.train.lr, cfg.train.lr_milestones,
                        cfg.train.lr_gamma, cfg.train.warmup_steps,
                        cfg.train.warmup_factor)


class TrainState:
    """step, params, batch_stats, Adam (count, mu, nu), schedule count.

    Adam is the reference's: betas (0.9, 0.999), eps 1e-8, no weight
    decay (the reference config declares weight_decay but builds Adam
    without it, rrnet_operator.py:29)."""

    def __init__(self, layout: Layout, params: torch.Tensor,
                 batch_stats: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, step: torch.Tensor, count: torch.Tensor,
                 sched_count: torch.Tensor, schedule: Callable,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.layout = layout
        self.flat_params = params
        self.flat_stats = batch_stats
        self.mu = mu
        self.nu = nu
        self.step = step
        self.count = count
        self.sched_count = sched_count
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps

    # ---- views ---------------------------------------------------------
    def params(self) -> Dict[str, torch.Tensor]:
        return views(self.flat_params, self.layout.params)

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return views(self.flat_stats, self.layout.stats)

    def moments(self) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        return (views(self.mu, self.layout.params),
                views(self.nu, self.layout.params))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state_dict (parameters and buffers) as views."""
        return {**self.params(), **self.batch_stats()}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state, by field."""
        return {"params": self.flat_params, "batch_stats": self.flat_stats,
                "mu": self.mu, "nu": self.nu, "step": self.step,
                "count": self.count, "sched_count": self.sched_count}

    @property
    def device(self) -> torch.device:
        return self.flat_params.device

    def to(self, device) -> "TrainState":
        """A copy of the state on `device`."""
        t = {k: v.to(device, copy=True) for k, v in self.tensors().items()}
        return TrainState(self.layout, t["params"], t["batch_stats"],
                          t["mu"], t["nu"], t["step"], t["count"],
                          t["sched_count"], self.schedule, self.b1, self.b2,
                          self.eps)

    @classmethod
    def from_tensors(cls, layout: Layout, params: Mapping[str, torch.Tensor],
                     batch_stats: Mapping[str, torch.Tensor], *,
                     schedule: Callable, device) -> "TrainState":
        """A fresh state from per-name tensors: zero moments and counts."""
        fp = _flat(params, layout.params, device)

        def zero():
            return torch.zeros((), dtype=torch.int64, device=device)
        return cls(layout, fp, _flat(batch_stats, layout.stats, device),
                   torch.zeros_like(fp), torch.zeros_like(fp), zero(),
                   zero(), zero(), schedule)

    # ---- the update ----------------------------------------------------
    def apply_gradients(self, grads: torch.Tensor,
                        good: Optional[torch.Tensor] = None,
                        old_batch_stats: Optional[torch.Tensor] = None
                        ) -> "TrainState":
        """Adam on the flat gradient `grads`, with the JAX package's fused
        exact skip: `good` (0-dim bool, None for always) scales every
        delta,
            mu'    = mu    + good * (1-b1) * (g  - mu)
            nu'    = nu    + good * (1-b2) * (g2 - nu)
            param' = param - good * lr * mu_hat / (sqrt(nu_hat) + eps)
            count' = count + good  (Adam's, the schedule's, the step)
        so good=1 is optax.adam's update and good=0 changes nothing. The
        forward updated the BN running statistics in place; with
        `old_batch_stats` (their values before it) a skipped step puts
        them back. lr = schedule(schedule count) is read before the
        count moves, as optax's scale_by_schedule does."""
        dev = self.device
        g1 = (torch.ones((), dtype=torch.float32, device=dev) if good is None
              else good.to(torch.float32))
        gi = g1.to(torch.int64)
        count = self.count + gi
        # on a skipped FIRST step count stays 0 and 1 - b**0 == 0 would
        # give 0/0; the update is scaled by good = 0 anyway
        cf = count.clamp(min=1).to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, device=dev), cf)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, device=dev), cf)
        lr = self.schedule(self.sched_count)

        g = grads.to(torch.float32)
        d = (g - self.mu).mul_(1.0 - self.b1).mul_(g1)
        self.mu.add_(d)
        d = torch.mul(g, g).sub_(self.nu).mul_(1.0 - self.b2).mul_(g1)
        self.nu.add_(d)
        del d
        upd = torch.div(self.mu, c1)
        upd.div_(torch.div(self.nu, c2).sqrt_().add_(self.eps))
        self.flat_params.sub_(upd.mul_(g1 * lr))
        del upd

        if old_batch_stats is not None:
            # a select, not a lerp: a skipped forward's statistics may be
            # NaN, and NaN * 0 is NaN
            self.flat_stats.copy_(torch.where(g1 >= 1.0, self.flat_stats,
                                              old_batch_stats))
        self.count = count
        self.sched_count = self.sched_count + gi
        self.step = self.step + gi
        return self


def create_train_state(cfg: Config, model: nn.Module,
                       device=None) -> TrainState:
    """The state of `model`'s current weights and statistics, with zero
    moments and counts, on `device` (default: the model's)."""
    if device is None:
        device = next(model.parameters()).device
    return TrainState.from_tensors(
        Layout.of(model), dict(model.named_parameters()),
        dict(model.named_buffers()), schedule=make_schedule(cfg),
        device=device)
