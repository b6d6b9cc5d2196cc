"""Data parallelism over `torch.distributed` (port of
`rrnet_tpu/parallel/`)."""

from rrnet_torch.parallel.mesh import (DataGroup, all_mean, all_mean_,
                                       create_group, init_from_env,
                                       replicate, shard_batch)

__all__ = ["DataGroup", "all_mean", "all_mean_", "create_group",
           "init_from_env", "replicate", "shard_batch"]
