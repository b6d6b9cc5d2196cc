"""Data-parallel groups over `torch.distributed` (port of
`rrnet_tpu/parallel/mesh.py:28-77`).

The JAX package describes its data parallelism as a device mesh: the
batch sharded on the `data` axis, the gradients and the logged losses
`lax.pmean`'d over it inside `shard_map`, the SyncBN statistics riding
the same axis through flax's `BatchNorm(axis_name=...)`. Here one process
is one rank on one device, as under `torchrun`:

  * `init_from_env` joins the process group `torchrun` describes in the
    environment (NCCL for ranks on cards, gloo on the CPU);
  * `create_group(cfg.mesh, device)` checks the mesh description against
    the world and returns a `DataGroup`;
  * `shard_batch` is a rank's contiguous slice of a global host batch
    (the loader shards a split by rank the same way,
    `data.loader.TrainLoader(process_index=, process_count=)`);
  * `replicate` broadcasts state from rank 0;
  * `all_mean` is `lax.pmean` as an autograd function: forward
    all_reduce(SUM) / W, backward the same on the cotangent, the
    transpose `shard_map(check_vma=False)` gives `pmean`.

With no group, or a world of one rank, every function returns its input
and issues no collective. `collectives` counts the collectives issued in
this process.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Iterable, Optional, Union

import torch
import torch.distributed as dist

from rrnet_torch.config import MeshConfig
from rrnet_torch.utils.device import resolve_device

__all__ = ["DataGroup", "init_from_env", "create_group", "shard_batch",
           "replicate", "all_mean", "all_mean_", "collectives"]

collectives = 0


@dataclass(frozen=True)
class DataGroup:
    """A data-parallel process group: `group` (None for the default
    group), this process's `rank` in it, its `world_size`, and the
    `device` this rank computes on."""
    group: Optional[Any]
    rank: int
    world_size: int
    device: torch.device


def init_from_env(device: Union[str, torch.device] = "cuda",
                  timeout_s: float = 1800.0) -> torch.device:
    """Join the process group that `torchrun` describes in RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT: over NCCL on
    `cuda:LOCAL_RANK` for a CUDA `device`, over gloo on the CPU. A
    rendezvous or collective that waits longer than `timeout_s` raises.
    Returns this rank's device."""
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        dev = resolve_device(f"cuda:{int(env.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=timedelta(seconds=timeout_s))
    return dev


def create_group(cfg: Optional[MeshConfig] = None,
                 device: Union[str, torch.device] = "cuda",
                 group: Optional[Any] = None) -> DataGroup:
    """The data-parallel group of `cfg` over `group` (default: the
    default process group; a world of one rank when none is
    initialised). `data_parallel == -1` means every rank; the mesh must
    cover the world exactly, as `create_mesh` requires of the devices."""
    cfg = cfg or MeshConfig()
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    mp = max(cfg.model_parallel, 1)
    if mp > 1:
        raise ValueError(
            f"mesh.model_parallel={cfg.model_parallel}: no model uses the "
            f"'{cfg.model_axis}' axis, so only data parallelism is ported")
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world // mp
    if dp * mp != world:
        raise ValueError(
            f"mesh {dp}x{mp} does not cover {world} devices; set "
            f"mesh.data_parallel/model_parallel to factor the device count")
    return DataGroup(group, rank, world, resolve_device(device))


def _active(dg: Optional[DataGroup]) -> bool:
    return dg is not None and dg.world_size > 1


def shard_batch(batch: Any, dg: Optional[DataGroup]) -> Any:
    """This rank's contiguous slice of a global host batch (a dict of
    arrays with the batch first, divisible by the world size)."""
    if not _active(dg):
        return batch
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % dg.world_size:
            raise ValueError(f"batch {k!r} of {n} does not split over "
                             f"{dg.world_size} ranks")
        per = n // dg.world_size
        out[k] = v[dg.rank * per:(dg.rank + 1) * per]
    return out


def replicate(tensors: Iterable[torch.Tensor],
              dg: Optional[DataGroup]) -> None:
    """Broadcast each tensor from the group's rank 0, in place. Every rank
    draws the same seeded weights, so on a sound launch this changes
    nothing; it makes rank 0's state everyone's whatever the seeds."""
    global collectives
    if not _active(dg):
        return
    for t in tensors:
        dist.broadcast(t, group=dg.group, group_src=0)
        collectives += 1


def _mean_(y: torch.Tensor, dg: DataGroup) -> torch.Tensor:
    global collectives
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=dg.group)
    collectives += 1
    return y.div_(dg.world_size)


def _mean(x: torch.Tensor, dg: DataGroup) -> torch.Tensor:
    return _mean_(x.clone(memory_format=torch.contiguous_format), dg)


class _AllMean(torch.autograd.Function):
    """`lax.pmean` and its transpose under `shard_map(check_vma=False)`:
    the mean over the ranks forward, and again on the cotangent."""

    @staticmethod
    def forward(ctx, x, dg):
        ctx.dg = dg
        return _mean(x, dg)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.dg), None


def all_mean(x: torch.Tensor, dg: Optional[DataGroup]) -> torch.Tensor:
    """The mean of `x` over the group's ranks (every rank gets the same
    bits), differentiable; `x` itself without a group or at world 1."""
    if not _active(dg):
        return x
    return _AllMean.apply(x, dg)


def all_mean_(x: torch.Tensor, dg: Optional[DataGroup]) -> torch.Tensor:
    """`all_mean` in place on a contiguous `x` outside autograd (the flat
    gradient: no copy of it is made). Returns `x`."""
    if _active(dg):
        _mean_(x, dg)
    return x

