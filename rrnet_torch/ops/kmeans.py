"""Lloyd k-means for anchor priors (port of `rrnet_tpu/ops/kmeans.py`;
reference ext/kmeans/kmeans.py:6-36, pairwise.py:6-40, driven by
scripts/kmeans.py).

Forgy init (k distinct data rows), then a fixed `iters` Lloyd updates
with squared-L2 distances; a cluster that loses all its rows keeps a
count of 1 and so moves to the origin, as in the JAX package. It runs on
the device of `data`.

The init is drawn with a `torch.Generator` (`seed`, or the caller's
`generator`): `jax.random.choice` draws other indices, which torch
cannot reproduce. `init_idx` takes given init rows instead, so a run can
start where the JAX package's starts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rrnet_torch.utils.device import resolve_device


def pairwise_sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D) x (N, D) -> (M, N) squared L2 (pairwise.py:6-28)."""
    diff = a[:, None, :] - b[None, :, :]
    return (diff * diff).sum(-1)


def kmeans(data: torch.Tensor, k: int, seed: int = 0, iters: int = 100,
           init_idx=None, generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means of `data` (N, D). Returns (centers (k, D), the
    assignment (N,) int64), on `data`'s device. The k init rows are
    `init_idx` where given, else k distinct rows drawn by `generator`
    (default: a CPU generator seeded with `seed`)."""
    if init_idx is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        init_idx = torch.randperm(data.shape[0], generator=generator,
                                  device=generator.device)[:k]
    if not isinstance(init_idx, torch.Tensor):
        init_idx = torch.tensor(np.asarray(init_idx))
    init_idx = init_idx.to(data.device).long()
    centers = data[init_idx]
    for _ in range(iters):
        assign = pairwise_sq_dist(data, centers).argmin(1)
        onehot = F.one_hot(assign, k).to(data.dtype)        # (N, k)
        counts = onehot.sum(0).clamp_min(1.0)
        centers = (onehot.T @ data) / counts[:, None]
    return centers, pairwise_sq_dist(data, centers).argmin(1)


def anchor_priors_from_dataset(loader, k: int = 3, max_batches: int = 200,
                               device="cuda"
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """The GT (w, h) of `max_batches` batches of a `TrainLoader`,
    clustered on `device`, heights and widths apart (seed 0 each).
    Returns the sorted (heights, widths) as numpy."""
    dev = resolve_device(device)
    whs = []
    for _ in range(max_batches):
        batch = loader.get_batch()
        whs.append(np.asarray(batch["annos"])[np.asarray(batch["valid"])]
                   [:, 2:4])
    wh = torch.from_numpy(np.concatenate(whs).astype(np.float32)).to(dev)
    hc, _ = kmeans(wh[:, 1:2], k, seed=0)
    wc, _ = kmeans(wh[:, 0:1], k, seed=0)
    return (np.sort(hc.cpu().numpy().ravel()),
            np.sort(wc.cpu().numpy().ravel()))
