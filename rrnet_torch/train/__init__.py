"""Training (port of `rrnet_tpu/train/`): the `Trainer` and its train
state, criterions and schedule, on one card or as a rank of a
data-parallel group."""

from rrnet_torch.train.state import TrainState
from rrnet_torch.train.trainer import Trainer

__all__ = ["Trainer", "TrainState"]
