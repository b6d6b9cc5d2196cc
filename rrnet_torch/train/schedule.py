"""Learning-rate schedule (port of `rrnet_tpu/train/schedule.py:23-43`).

MultiStepLR with optional linear or constant warmup (maskrcnn-benchmark's
WarmupMultiStepLR). The reference steps its scheduler before the
optimizer (PyTorch-1.1 order), so update i uses the rate of counter i+1:
a milestone takes effect one update early. The schedule reproduces that:
update i is decayed when i + 1 >= milestone.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1, warmup_steps: int = 0,
                 warmup_factor: float = 1.0 / 3.0,
                 warmup_method: str = "linear") -> Callable:
    """schedule(step) -> the f32 rate of update `step` (an int or a 0-dim
    integer tensor; the result is a 0-dim tensor on its device)."""
    ms = sorted(int(m) for m in milestones)

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step)
        dev = step.device
        stepf = step.to(torch.float32)
        eff = stepf + 1.0           # PyTorch-1.1 pre-step order (module doc)
        gamma_t = torch.tensor(gamma, dtype=torch.float32, device=dev)
        if ms:
            n_hit = (eff >= torch.tensor(ms, dtype=torch.float32,
                                         device=dev)).sum().to(torch.float32)
        else:
            n_hit = torch.zeros((), dtype=torch.float32, device=dev)
        lr = base_lr * torch.pow(gamma_t, n_hit)
        if warmup_steps > 0:
            if warmup_method == "linear":
                alpha = stepf / warmup_steps
                w = warmup_factor * (1 - alpha) + alpha
            else:
                w = torch.tensor(warmup_factor, dtype=torch.float32,
                                 device=dev)
            lr = torch.where(step < warmup_steps, lr * w, lr)
        return lr

    return schedule
