"""The all-meaned gradients of the port's data-parallel step at init, in
f64, against the JAX package's: the tiny RRNet of tests/test_torch_ddp.py
(same weights, same global batch of 8, each of two gloo ranks on the CPU
taking its contiguous half) with both packages' models computing in f64
and SyncBN over the two ranks, against the JAX model's gradient
`lax.pmean`'d inside `shard_map` over a 2-device mesh, SyncBN through
flax's `BatchNorm(axis_name="data")` (what the JAX Trainer's
`loss_and_grads` computes). f64, because the f32 gradients are
ill-conditioned at ReLU kinks (tests/test_torch_train.py); the losses
cast the maps to f32 in both packages, so the f64 gradients carry f32
rounding of the loss terms. Tolerance: every gradient within 1e-6 of its
largest magnitude, the single-card tiny step's. The ranks get the same
gradient bits, and `Trainer.loss_and_grads` issues one collective a
batch norm forward and one backward, one for the gradient and one for
the total.
"""

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from tests import torch_ranks
from tests.test_torch_ddp import (TINY, flax_variables, global_batch,
                                  spread_heatmap)
from tests.test_torch_train import as_float64, close
from torch_threads import one_torch_thread  # noqa: F401


def rank_main():
    import torch.distributed as dist
    from rrnet_torch.models import build_model
    from rrnet_torch.parallel import (all_mean_, create_group, mesh,
                                      shard_batch)
    from rrnet_torch.train import Trainer

    torch_ranks.join()
    cfg = tcfg.rrnet_config(**TINY)
    dg = create_group(cfg.mesh, "cpu")
    local = shard_batch(global_batch(0), dg)
    tr = Trainer(cfg, device="cpu", group=dg)
    spread_heatmap(tr.model)
    state = tr.init_state()
    c0 = mesh.collectives
    _, g32 = tr.loss_and_grads(state, local)
    out = {"collectives": mesh.collectives - c0, "g32": g32,
           "n_bn": sum(type(m).__name__ == "BatchNorm"
                       for m in tr.model.modules())}

    tm = as_float64(spread_heatmap(build_model(cfg, device="cpu",
                                               group=dg))).train()
    outs = tm(torch.from_numpy(local["images"]).permute(0, 3, 1, 2).double())
    total, _ = tr._losses(outs, torch.from_numpy(local["annos"]),
                          torch.from_numpy(local["valid"]), torch.tensor(0))
    named = list(tm.named_parameters())
    g = torch.autograd.grad(total, [p for _, p in named], allow_unused=True,
                            materialize_grads=True)
    flat = all_mean_(torch.cat([x.reshape(-1) for x in g]), dg)
    out["g64"] = {k: x.view(p.shape) for (k, p), x in zip(
        named, torch.split(flat, [p.numel() for _, p in named]))}
    torch.save(out, f"rank{dg.rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from rrnet_tpu import config as jcfg
    from rrnet_tpu.models.rrnet import RRNet as JRRNet
    from rrnet_tpu.parallel.mesh import create_mesh
    from rrnet_tpu.train import Trainer as JTrainer
    from rrnet_torch.models import build_model
    from rrnet_torch.utils.from_flax import numpy_state_from_flax

    tmp = tmp_path_factory.mktemp("ddp_grads")
    procs = torch_ranks.start(
        "import test_torch_ddp_grads as t; t.rank_main()", 2, tmp)
    try:
        jc = jcfg.rrnet_config(**TINY)
        mesh = create_mesh(jc.mesh, jax.devices()[:2])
        jt = JTrainer(jc, mesh=mesh)
        m = jc.model
        with jax.enable_x64(True):
            jm = JRRNet(num_classes=jc.num_classes, num_stacks=m.num_stacks,
                        backbone=m.backbone, topk=m.topk,
                        stage2_rois=m.stage2_rois,
                        nms_type=m.nms_type_for_stage1, bn_axis="data",
                        dtype=jnp.float64)
            sd = spread_heatmap(build_model(tcfg.rrnet_config(**TINY),
                                            device="cpu")).state_dict()
            v = jax.tree.map(lambda a: np.asarray(a, np.float64),
                             flax_variables(jt.model, sd))

            def grads(params, x, annos, valid):
                def loss(p):
                    o, _ = jm.apply({"params": p,
                                     "batch_stats": v["batch_stats"]},
                                    x, train=True, mutable=["batch_stats"])
                    return jt._losses(o, annos, valid, jnp.int32(0))[0]
                return jax.lax.pmean(jax.grad(loss)(params), "data")

            b = global_batch(0)
            g = jax.jit(shard_map(
                grads, mesh=mesh,
                in_specs=(P(), P("data"), P("data"), P("data")),
                out_specs=P(), check_vma=False))(
                v["params"], b["images"].astype(np.float64), b["annos"],
                b["valid"])
            g = numpy_state_from_flax({"params": jax.tree.map(np.asarray,
                                                              g)})
    finally:
        torch_ranks.wait(procs, timeout=240)
    return dict(ranks=[torch.load(tmp / f"rank{r}.pt") for r in range(2)],
                g64=g)


def test_allmeaned_gradients_at_init_match_jax_in_f64(runs):
    jg, tg = runs["g64"], runs["ranks"][0]["g64"]
    assert sorted(tg) == sorted(jg)
    for k in jg:
        close(tg[k].numpy(), jg[k], rtol=1e-6, what=k)
    assert np.abs(jg["hm.out0.weight"]).max() > 0


def test_ranks_get_the_same_gradient(runs):
    r0, r1 = runs["ranks"]
    for name in ("g32", "g64"):
        for k in r0[name]:
            assert torch.equal(r0[name][k], r1[name][k]), (name, k)


def test_loss_and_grads_collectives(runs):
    for r in runs["ranks"]:
        assert r["collectives"] == 2 * r["n_bn"] + 2
