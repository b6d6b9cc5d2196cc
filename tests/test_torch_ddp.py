"""The port's data-parallel train step (`rrnet_torch.parallel`, SyncBN in
`models.layers.BatchNorm`, `train.Trainer(group=...)`) on two gloo ranks
on the CPU, against the JAX package's `Trainer` on a 2-device mesh
(`create_mesh(jc.mesh, jax.devices()[:2])`: the step `shard_map`'d over
the data axis, SyncBN through flax's `BatchNorm(axis_name="data")`).

The setup is `tests/test_multiprocess_train.py`'s: the rrnet preset on
tiny_hourglass, crop 64, 16 objects, topk 32, 8 ROIs, stage 2 from step
1, f32, a global batch of 8 made from a seed with numpy, each rank taking
its contiguous half as each JAX device holds its shard. Both packages
start from the port's seeded weights (carried into a flax tree whose
structure `jax.eval_shape` traces, so no JAX init is compiled), the
heatmap out-convs scaled by 8 so that top-k and NMS see no near-ties.
Not by 40, as the single-card tests do: on this batch that puts logits
near the focal loss's clamp of the sigmoid at 1 - 1e-4, whose f32
rounding differs by an ulp between XLA and torch, and an element
crossing it moves the f64 gradients of the deepest convs far past the
1e-6 bound, between the two packages on one process too, with no
collective involved (tests/test_torch_ddp_grads.py holds those
gradients). Tolerances:
  * the total loss at init (all-meaned): rtol 1e-4, as the single-card
    tiny step (f32 convolutions summed in another order);
  * 3 steps: totals rtol 1e-3; every param within 5e-3 (20 lr) of the
    JAX step's, the envelope of `tests/test_multiprocess_train.py`, and
    99% within 2.5e-4 (1 lr). That file holds 95% within 1e-4 (0.4 lr),
    but it compares the JAX package with itself, whose gradients differ
    by an ulp; between the packages the f32 gradients differ by up to
    ~1e-2 of their largest magnitude at ReLU kinks (tests/test_torch_
    train.py), and Adam turns a gradient's relative error into that
    share of lr: here 93.8% lie within 0.4 lr, 99.22% within 1 lr,
    99.92% within 2 lr, the worst at 5.1 lr, the largest shares in the
    hourglass's BN affine parameters. The gradients themselves are held
    in f64 by tests/test_torch_ddp_grads.py;
  * rank 0's SyncBN running statistics after the first step against the
    JAX state's: rtol 1e-4 of the largest magnitude;
  * the two ranks bitwise equal in params, statistics, moments, counts
    and step; a world of one rank bitwise equal to the plain Trainer and
    issuing no collective; a non-finite batch on rank 1 alone skipping
    the step on both ranks, bitwise.
The ranks run while the JAX step compiles.
"""

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from tests import torch_ranks
from tests.test_torch_train import close
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"model.backbone": "tiny_hourglass", "model.topk": 32,
        "model.stage2_rois": 8, "model.dtype": "float32",
        "train.crop_size": (64, 64), "train.max_objects": 16,
        "train.stage2_warmup_steps": 1}


def global_batch(seed, b=8, n=16, hw=64):
    """tests/test_multiprocess_train.py's global batch."""
    rng = np.random.RandomState(seed)
    images = rng.randn(b, hw, hw, 3).astype(np.float32)
    xy = rng.rand(b, n, 2) * (hw - 24)
    wh = rng.rand(b, n, 2) * 16 + 4
    cls = rng.randint(1, 11, (b, n, 1)).astype(np.float32)
    pad = np.ones((b, n, 1), np.float32)
    annos = np.concatenate([xy, wh, pad, cls, pad, pad], -1).astype(
        np.float32)
    valid = np.ones((b, n), bool)
    valid[:, n // 2:] = rng.rand(b, n - n // 2) > 0.3
    return {"images": images, "annos": annos, "valid": valid}


def spread_heatmap(model, scale=8.0):
    """The port model's heatmap out-convs scaled (module docstring)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("hm.out") and name.endswith("weight"):
                p.mul_(scale)
    return model


def flax_variables(module, sd, hw=64):
    """The flax variables of `module` holding the port's state dict `sd`:
    the tree's structure comes from `jax.eval_shape` of its init (traced,
    not run), each leaf from the port tensor that `utils.from_flax`
    maps it to."""
    import jax
    import jax.numpy as jnp
    from rrnet_torch.utils.from_flax import numpy_state_from_flax
    shapes = jax.eval_shape(lambda x: module.init(
        jax.random.PRNGKey(0), x, train=False), jnp.zeros((1, hw, hw, 3)))
    off = 0

    def index(s):
        nonlocal off
        a = np.arange(off, off + int(np.prod(s.shape))).reshape(s.shape)
        off += a.size
        return a
    idx = jax.tree.map(index, shapes)
    flat = np.full(off, np.nan, np.float32)
    for k, where in numpy_state_from_flax(dict(idx)).items():
        flat[np.ravel(where)] = sd[k].detach().numpy().ravel()
    assert not np.isnan(flat).any()
    return jax.tree.map(lambda a: flat[a], idx)


def jax_state(jt, variables):
    """The JAX Trainer's TrainState on `variables`, replicated on its
    mesh (what `init_state` returns, without compiling the init)."""
    import jax
    import jax.numpy as jnp
    from rrnet_tpu.parallel.mesh import replicate
    from rrnet_tpu.train.state import (TrainState, make_optimizer,
                                       make_schedule)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = make_optimizer(jt.cfg)
    st = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                    batch_stats=jax.tree.map(jnp.asarray,
                                             variables["batch_stats"]),
                    opt_state=tx.init(params), apply_fn=jt.model.apply,
                    tx=tx, schedule=make_schedule(jt.cfg))
    return replicate(st, jt.mesh)


def bits(state):
    return {k: (v.view(torch.int32) if v.is_floating_point() else v).clone()
            for k, v in state.tensors().items()}


def same_bits(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def rank_main():
    """One rank: the tiny RRNet's data-parallel steps, saved for the test
    to hold against the JAX package."""
    import torch.distributed as dist
    from rrnet_torch.parallel import create_group, mesh, shard_batch
    from rrnet_torch.train import Trainer

    torch_ranks.join()
    cfg = tcfg.rrnet_config(**TINY)
    dg = create_group(cfg.mesh, "cpu")

    def trainer(group):
        tr = Trainer(cfg, device="cpu", group=group)
        spread_heatmap(tr.model)
        return tr, tr.init_state()

    tr, state = trainer(dg)
    out = {"n_bn": sum(type(m).__name__ == "BatchNorm"
                       for m in tr.model.modules())}
    loss0, _ = tr.loss_and_grads(state, shard_batch(global_batch(0), dg))
    out["loss0"] = float(loss0)
    totals = []
    for step in range(3):
        c0 = mesh.collectives
        state, m = tr.train_step(state, shard_batch(global_batch(step), dg))
        out["step_collectives"] = mesh.collectives - c0
        totals.append(float(m["total"]))
        if step == 0:
            out["stats1"] = state.flat_stats.clone()
    out["totals"] = totals
    out["state"] = {k: v.clone() for k, v in state.tensors().items()}

    # rank 1's batch alone is non-finite: both ranks skip, bitwise
    bad = shard_batch(global_batch(3), dg)
    if dg.rank == 1:
        bad = dict(bad, images=np.full_like(bad["images"], np.inf))
    before = bits(state)
    state, m = tr.train_step(state, bad)
    out["inf_skipped"] = float(m["skipped"])
    out["inf_total"] = float(m["total"])
    out["inf_state_unchanged"] = same_bits(before, bits(state))

    # a world of one rank (this rank's own group) is the plain step
    ones = [dist.new_group([r]) for r in range(dg.world_size)]
    one = create_group(cfg.mesh, "cpu", group=ones[dg.rank])
    (a, sa), (b, sb) = trainer(one), trainer(None)
    local = shard_batch(global_batch(0), dg)
    c0 = mesh.collectives
    sa, ma = a.train_step(sa, local)
    out["world1_collectives"] = mesh.collectives - c0
    sb, mb = b.train_step(sb, local)
    out["world1_bitwise"] = (
        same_bits(bits(sa), bits(sb))
        and all(torch.equal(ma[k], mb[k]) for k in mb))
    torch.save(out, f"rank{dg.rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX 2-device steps and the port's two ranks on the same
    weights and batches."""
    import jax
    from rrnet_tpu import config as jcfg
    from rrnet_tpu.parallel.mesh import create_mesh
    from rrnet_tpu.train import Trainer as JTrainer
    from rrnet_torch.models import build_model
    from rrnet_torch.train.state import Layout
    from rrnet_torch.utils.from_flax import numpy_state_from_flax

    tmp = tmp_path_factory.mktemp("ddp")
    procs = torch_ranks.start(
        "import test_torch_ddp as t; t.rank_main()", 2, tmp)
    try:
        model = spread_heatmap(build_model(tcfg.rrnet_config(**TINY),
                                           device="cpu"))
        jc = jcfg.rrnet_config(**TINY)
        jt = JTrainer(jc, mesh=create_mesh(jc.mesh, jax.devices()[:2]))
        state = jax_state(jt, flax_variables(jt.model, model.state_dict()))
        totals, stats1 = [], None
        for step in range(3):
            state, met = jt.train_step(state, jt.shard(global_batch(step)))
            totals.append(float(met["total"]))
            if step == 0:
                stats1 = numpy_state_from_flax({"batch_stats": jax.tree.map(
                    np.asarray, state.batch_stats)})
        final = numpy_state_from_flax({"params": jax.tree.map(
            np.asarray, state.params)})
    finally:
        torch_ranks.wait(procs, timeout=240)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return dict(ranks=ranks, totals=totals, stats1=stats1, final=final,
                layout=Layout.of(model))


def test_loss_at_init_matches_jax(runs):
    # the JAX step's first total is its all-meaned loss at init
    for r in runs["ranks"]:
        close(r["loss0"], runs["totals"][0], rtol=1e-4, what="total")
        assert r["totals"][0] == r["loss0"]


def test_three_steps_match_jax(runs):
    from rrnet_torch.train.state import views
    r0 = runs["ranks"][0]
    np.testing.assert_allclose(r0["totals"], runs["totals"], rtol=1e-3)
    params = views(r0["state"]["params"], runs["layout"].params)
    assert sorted(params) == sorted(runs["final"])
    diffs = np.concatenate([np.abs(params[k].numpy().astype(np.float64)
                                   - runs["final"][k]).ravel()
                            for k in params])
    share = [float(np.mean(diffs < t)) for t in (1e-4, 2.5e-4, 5e-4)]
    assert share[1] > 0.99, share
    assert np.max(diffs) < 5e-3, float(np.max(diffs))
    # a step: every BN's forward and backward, the gradient, the skip
    # flag and the metrics, one collective each
    assert r0["step_collectives"] == 2 * r0["n_bn"] + 3


def test_syncbn_running_statistics_match_jax(runs):
    from rrnet_torch.train.state import views
    got = views(runs["ranks"][0]["stats1"], runs["layout"].stats)
    assert sorted(got) == sorted(runs["stats1"])
    for k, w in runs["stats1"].items():
        close(got[k].numpy(), w, rtol=1e-4, what=k)


def test_ranks_are_bitwise_equal(runs):
    r0, r1 = runs["ranks"]
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert int(r0["state"]["step"]) == 3
    assert r0["totals"] == r1["totals"]
    assert torch.equal(r0["stats1"], r1["stats1"])


def test_world_of_one_is_the_plain_step(runs):
    for r in runs["ranks"]:
        assert r["world1_bitwise"]
        assert r["world1_collectives"] == 0


def test_one_rank_non_finite_skips_every_rank(runs):
    for r in runs["ranks"]:
        assert r["inf_skipped"] == 1.0
        assert not np.isfinite(r["inf_total"])
        assert r["inf_state_unchanged"]
