"""SyncBN and per-rank statistics of the port's data parallelism against
the JAX package's, on two gloo ranks on the CPU and a 2-device mesh, and
the mesh description's checks.

  * One SyncBN layer (`models.layers.BatchNorm` with a group) across two
    ranks, each with its contiguous half of a seeded (4, 6, 5, 7) batch:
    its train forward, the VJP for the input and for each rank's scale
    and bias, and the running statistics, against the JAX package's
    `BatchNorm(axis_name="data")` (flax's `nn.BatchNorm`) under
    `shard_map` on 2 devices with `check_vma=False`, as the JAX Trainer
    runs it. f32 reductions in another order: within 1e-5 of the largest
    magnitude.
  * A preset without SyncBN (the tiny CenterNet: tiny_hourglass, f32,
    crop 64, 16 objects, a global batch of 4) takes one step on two
    ranks and on the JAX Trainer's 2-device mesh. Each rank keeps its own
    shard's running statistics, as each JAX device keeps its own under
    `out_specs=P()` with `check_vma=False`: rank r's against device r's,
    rtol 1e-4 of the largest magnitude (rank 0's is what a checkpoint
    holds, device 0's is what the JAX package's holds). Losses rtol
    1e-4; params within 2 lr of the JAX step's and 99.5% within 1e-2 lr,
    the single-card tiny step's bounds (Adam's first step is lr times the
    sign of the gradient); params and moments bitwise equal on the two
    ranks.
  * `MeshConfig` equals the JAX package's field for field; a mesh that
    does not cover the world is refused with `create_mesh`'s message,
    and `model_parallel > 1` is refused (no model uses the model axis).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from tests import torch_ranks
from tests.test_torch_ddp import flax_variables, global_batch, jax_state
from tests.test_torch_train import close
from torch_threads import one_torch_thread  # noqa: F401

CENTERNET = {"model.backbone": "tiny_hourglass", "model.dtype": "float32",
             "train.crop_size": (64, 64), "train.max_objects": 16}


def bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 7) * 2 + 0.5).astype(np.float32)
    ct = rng.randn(4, 6, 5, 7).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    b = (rng.randn(6) * 0.1).astype(np.float32)
    rm = (rng.randn(6) * 0.1).astype(np.float32)
    rv = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    return x, ct, w, b, rm, rv


def rank_main():
    import torch.distributed as dist
    from rrnet_torch.models.layers import BatchNorm, set_sync_group
    from rrnet_torch.parallel import create_group, shard_batch
    from rrnet_torch.train import Trainer

    torch_ranks.join()
    dg = create_group(tcfg.MeshConfig(), "cpu")
    out = {}
    try:
        create_group(tcfg.MeshConfig(data_parallel=1), "cpu")
    except ValueError as e:
        out["cover_error"] = str(e)

    x, ct, w, b, rm, rv = bn_inputs()
    half = slice(2 * dg.rank, 2 * dg.rank + 2)
    bn = set_sync_group(BatchNorm(6), dg).train()
    with torch.no_grad():
        for p, a in ((bn.weight, w), (bn.bias, b), (bn.running_mean, rm),
                     (bn.running_var, rv)):
            p.copy_(torch.from_numpy(a))
    xl = torch.from_numpy(x[half]).requires_grad_()
    y = bn(xl)
    y.backward(torch.from_numpy(ct[half]))
    out["bn"] = {"y": y.detach(), "gx": xl.grad, "gw": bn.weight.grad,
                 "gb": bn.bias.grad, "mean": bn.running_mean.clone(),
                 "var": bn.running_var.clone()}

    cfg = tcfg.centernet_config(**CENTERNET)
    tr = Trainer(cfg, device="cpu", group=create_group(cfg.mesh, "cpu"))
    state, m = tr.train_step(tr.init_state(),
                             shard_batch(global_batch(0, b=4), dg))
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["state"] = {k: v.clone() for k, v in state.tensors().items()}
    torch.save(out, f"rank{dg.rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from rrnet_tpu import config as jcfg
    from rrnet_tpu.models.layers import BatchNorm as JBatchNorm
    from rrnet_tpu.parallel.mesh import create_mesh
    from rrnet_tpu.train import Trainer as JTrainer
    from rrnet_torch.models import build_model
    from rrnet_torch.train.state import Layout
    from rrnet_torch.utils.from_flax import numpy_state_from_flax

    tmp = tmp_path_factory.mktemp("ddp_syncbn")
    procs = torch_ranks.start(
        "import test_torch_ddp_syncbn as t; t.rank_main()", 2, tmp)
    try:
        devices = jax.devices()[:2]
        mesh = create_mesh(jcfg.MeshConfig(), devices)
        try:
            create_mesh(jcfg.MeshConfig(data_parallel=1), devices)
        except ValueError as e:
            cover_error = str(e)

        x, ct, w, b, rm, rv = bn_inputs()
        jbn = JBatchNorm(axis_name="data")
        stats = {"BatchNorm_0": {"mean": rm, "var": rv}}

        def layer(params, x, ct):
            def f(p, x):
                y, mut = jbn.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"])
                return y, mut["batch_stats"]["BatchNorm_0"]
            y, vjp, new = jax.vjp(f, params, x, has_aux=True)
            gp, gx = vjp(ct)
            return y, gx, jax.tree.map(lambda a: a[None], gp), new

        nhwc = (0, 2, 3, 1)
        y, gx, gp, new = jax.jit(shard_map(
            layer, mesh=mesh, in_specs=(P(), P("data"), P("data")),
            out_specs=(P("data"), P("data"), P("data"), P()),
            check_vma=False))(
            {"BatchNorm_0": {"scale": w, "bias": b}}, x.transpose(nhwc),
            ct.transpose(nhwc))
        jbn_out = {"y": np.asarray(y).transpose(0, 3, 1, 2),
                   "gx": np.asarray(gx).transpose(0, 3, 1, 2),
                   "gw": np.asarray(gp["BatchNorm_0"]["scale"]),
                   "gb": np.asarray(gp["BatchNorm_0"]["bias"]),
                   "mean": np.asarray(new["mean"]),
                   "var": np.asarray(new["var"])}

        jc = jcfg.centernet_config(**CENTERNET)
        jt = JTrainer(jc, mesh=mesh)
        model = build_model(tcfg.centernet_config(**CENTERNET),
                            device="cpu")
        state = jax_state(jt, flax_variables(jt.model, model.state_dict()))
        state, met = jt.train_step(state, jt.shard(global_batch(0, b=4)))
        per_device = [numpy_state_from_flax({"batch_stats": jax.tree.map(
            lambda a: np.asarray(a.addressable_shards[i].data),
            state.batch_stats)}) for i in range(2)]
        params = numpy_state_from_flax({"params": jax.tree.map(
            np.asarray, state.params)})
        metrics = {k: float(v) for k, v in met.items()}
    finally:
        torch_ranks.wait(procs, timeout=240)
    return dict(ranks=[torch.load(tmp / f"rank{r}.pt") for r in range(2)],
                bn=jbn_out, cover_error=cover_error, stats=per_device,
                params=params, metrics=metrics, layout=Layout.of(model),
                lr=jc.train.lr)


def test_syncbn_layer_matches_flax_under_shard_map(runs):
    want = runs["bn"]
    for r, got in enumerate(rank["bn"] for rank in runs["ranks"]):
        half = slice(2 * r, 2 * r + 2)
        close(got["y"].numpy(), want["y"][half], rtol=1e-5, what="y")
        close(got["gx"].numpy(), want["gx"][half], rtol=1e-5, what="gx")
        close(got["gw"].numpy(), want["gw"][r], rtol=1e-5, what="gw")
        close(got["gb"].numpy(), want["gb"][r], rtol=1e-5, what="gb")
        close(got["mean"].numpy(), want["mean"], rtol=1e-5, what="mean")
        close(got["var"].numpy(), want["var"], rtol=1e-5, what="var")
    a, b = (rank["bn"] for rank in runs["ranks"])
    assert torch.equal(a["mean"], b["mean"]) and torch.equal(a["var"],
                                                             b["var"])


def test_per_rank_statistics_without_sync_bn_match_jax_devices(runs):
    from rrnet_torch.train.state import views
    layout = runs["layout"]
    r0, r1 = runs["ranks"]
    for r, rank in enumerate(runs["ranks"]):
        got = views(rank["state"]["batch_stats"], layout.stats)
        assert sorted(got) == sorted(runs["stats"][r])
        for k, w in runs["stats"][r].items():
            close(got[k].numpy(), w, rtol=1e-4, what=f"rank {r} {k}")
    assert not torch.equal(r0["state"]["batch_stats"],
                           r1["state"]["batch_stats"])
    for k in ("params", "mu", "nu", "step", "count", "sched_count"):
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    for k, v in runs["metrics"].items():
        close(r0["metrics"][k], v, rtol=1e-4, what=k)
        assert r0["metrics"][k] == r1["metrics"][k]
    got = views(r0["state"]["params"], layout.params)
    err = np.concatenate([np.abs(got[k].numpy() - w).ravel() / runs["lr"]
                          for k, w in runs["params"].items()])
    assert err.max() < 2.0 and np.mean(err > 1e-2) <= 5e-3, (
        err.max(), np.mean(err > 1e-2))


def test_mesh_config_equals_jax_and_covers_the_world(runs):
    from rrnet_tpu import config as jcfg
    assert (dataclasses.asdict(tcfg.MeshConfig())
            == dataclasses.asdict(jcfg.MeshConfig()))
    for rank in runs["ranks"]:
        assert rank["cover_error"] == runs["cover_error"]


def test_world_of_one_and_model_parallel_refusal():
    import jax
    from rrnet_tpu import config as jcfg
    from rrnet_tpu.parallel.mesh import create_mesh
    from rrnet_torch.parallel import (all_mean, all_mean_, create_group,
                                      mesh, replicate, shard_batch)
    dg = create_group(tcfg.MeshConfig(), "cpu")   # no process group here
    assert (dg.rank, dg.world_size, dg.group) == (0, 1, None)
    x = torch.arange(6.0)
    c0 = mesh.collectives
    assert all_mean(x, dg) is x and all_mean_(x, dg) is x
    batch = {"images": np.zeros((4, 2))}
    assert shard_batch(batch, dg) is batch
    replicate([x], dg)
    assert mesh.collectives == c0
    with pytest.raises(ValueError) as got:
        create_group(tcfg.MeshConfig(data_parallel=2), "cpu")
    with pytest.raises(ValueError) as want:
        create_mesh(jcfg.MeshConfig(data_parallel=2), jax.devices()[:1])
    assert str(got.value) == str(want.value)
    # the JAX package builds a 1x2 mesh here; no model uses its model
    # axis, and the port refuses it
    create_mesh(jcfg.MeshConfig(model_parallel=2), jax.devices()[:2])
    with pytest.raises(ValueError, match="model_parallel=2.*'model' axis"):
        create_group(tcfg.MeshConfig(model_parallel=2), "cpu")
