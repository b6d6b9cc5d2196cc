"""`ops.kmeans` and `scripts/kmeans.py` against the JAX package.

`jax.random.choice` draws the JAX init; torch cannot draw the same rows,
so the port is started from JAX's indices (`init_idx`) and must then
give equal assignments and centers within rtol 1e-5 (f32 sums in another
order), in 1-D and 2-D, with a cluster that empties (its count held at
1, so its center goes to the origin). The priors and the CLI run on the
synthetic set at a small crop.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_torch.data import synth
from rrnet_torch.ops.kmeans import (anchor_priors_from_dataset, kmeans,
                                    pairwise_sq_dist)
from rrnet_torch.scripts import kmeans as kmeans_cli
from torch_threads import one_torch_thread  # noqa: F401

jk = importlib.import_module("rrnet_tpu.ops.kmeans")


def jax_init(n, k, seed):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=False))


def data_sets():
    rng = np.random.RandomState(0)
    boxes = np.abs(rng.randn(300, 2) * 40 + 60).astype(np.float32)
    # two distinct values: any three init rows repeat one, so a cluster
    # loses every row on the first assignment
    steps = np.repeat(np.array([[3.0], [11.0]], np.float32), 40, axis=0)
    return [("2-D sizes", boxes, 5, 0), ("1-D heights", boxes[:, 1:], 3, 1),
            ("1-D two values", steps, 3, 2)]


@pytest.mark.parametrize("name,data,k,seed", data_sets(),
                         ids=[d[0] for d in data_sets()])
def test_kmeans_from_jax_init_matches_jax(name, data, k, seed):
    jc, ja = jk.kmeans(jnp.asarray(data), k, seed=seed)
    c, a = kmeans(torch.from_numpy(data), k,
                  init_idx=jax_init(len(data), k, seed))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    if name == "1-D two values":
        counts = np.bincount(a.numpy(), minlength=k)
        assert (counts == 0).any()
        assert (c.numpy()[counts == 0] == 0).all()


def test_pairwise_and_own_init():
    rng = np.random.RandomState(3)
    a, b = rng.randn(7, 2).astype(np.float32), rng.randn(4, 2).astype(
        np.float32)
    np.testing.assert_allclose(
        pairwise_sq_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jk.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6)
    data = torch.from_numpy(rng.rand(50, 2).astype(np.float32))
    c1, a1 = kmeans(data, 3, seed=4)
    c2, a2 = kmeans(data, 3, generator=torch.Generator().manual_seed(4))
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert a1.dtype == torch.int64 and c1.shape == (3, 2)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return synth.make_synth_dataset(str(tmp_path_factory.mktemp("km")),
                                    n_train=3, n_val=1)


SMALL = ["train.crop_size=(128,128)", "train.num_workers=1"]


def test_anchor_priors_and_cli_on_the_synthetic_set(synth_root):
    from rrnet_torch import config as cfglib
    from rrnet_torch.data.loader import TrainLoader
    cfg = cfglib.apply_overrides(cfglib.retinanet_config(),
                                 [f"data_root={synth_root}", *SMALL])
    loader = TrainLoader(cfg, batch_size=2, num_threads=1)
    try:
        hs, ws = anchor_priors_from_dataset(loader, k=3, max_batches=3,
                                            device="cpu")
    finally:
        loader.close()
    for p in (hs, ws):
        assert p.shape == (3,) and (np.diff(p) >= 0).all() and (p >= 0).all()
    assert hs.max() > 0 and ws.max() > 0
    hs2, ws2 = kmeans_cli.main(["--config", "retinanet", "--k", "2",
                                "--batches", "2", "--device", "cpu",
                                f"data_root={synth_root}", *SMALL])
    assert hs2.shape == ws2.shape == (2,)
