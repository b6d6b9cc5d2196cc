"""The port's RetinaNet train step, Evaluator and CLIs, on the CPU,
against the JAX package.

A resnet10 RetinaNet in f32 (the sizes of tests/test_train_step.py's
`tiny_cfg`: crop 64x64, 16 objects). Tolerances:
  * the train step against `rrnet_tpu.train.Trainer` (one-device mesh):
    losses rtol 1e-4; every gradient of the step computed in f64 by both
    packages: rtol 1e-6 of its largest magnitude (as
    tests/test_torch_train.py); the first and the second step from the
    same JAX state: params within 2 lr of the JAX step's, BN statistics
    rtol 1e-4, counts and step equal, and 99% of the params within 1e-2
    lr. Adam's first steps move an element by ~lr x the sign of its
    gradient, so an f32 gradient that is rounding noise (a cancelling
    sum; at crop 64 layer4 is 2x2 and its train-mode BN normalises over
    8 values) may step either way: 0.6% of this model's elements lie
    beyond 1e-2 lr, where the hourglass models' tests bound 0.5%; the
    f64 gradients above hold the arithmetic;
  * `Evaluator.predict_batch` against the JAX Evaluator on the same wire
    rows, the preset's protocol (scale 1, no flip) with no host merge:
    rows equal in count and class, boxes within 1e-3 px, scores within
    1e-5;
  * the train CLI's checkpoint restores into the eval and auto-eval
    CLIs, and the synthetic gate runs its retinanet row.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu import config as jcfg
from rrnet_tpu.evallib.infer import Evaluator as JEvaluator
from rrnet_tpu.models import build_model as j_build
from rrnet_torch import config as tcfg
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.models import build_model as t_build
from rrnet_torch.train import Trainer as TTrainer
from rrnet_torch.utils.from_flax import (load_flax_train_state,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from tests.test_torch_eval_protocol import (assert_rows_match, frames,
                                            predict_both)
from tests.test_torch_layers import randomize_bn
from tests.test_torch_train import (as_float64, close, jax_payload,
                                    random_annos)
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"model.backbone": "resnet10", "model.dtype": "float32"}
TRAIN = {**TINY, "train.crop_size": (64, 64), "train.max_objects": 16}
TINY_CLI = ["model.backbone=resnet10", "model.dtype=float32",
            "train.crop_size=(64,64)", "train.max_objects=16",
            "train.num_workers=1", "use_tensorboard=False"]


@pytest.fixture(scope="module")
def steps():
    from rrnet_tpu.parallel.mesh import create_mesh
    from rrnet_tpu.train import Trainer as JTrainer

    jc, tc = jcfg.retinanet_config(**TRAIN), tcfg.retinanet_config(**TRAIN)
    jt = JTrainer(jc, mesh=create_mesh(jc.mesh, jax.devices()[:1]))
    s0 = jt.init_state()
    rng = np.random.RandomState(5)
    annos, valid = random_annos(2, 16, 64, seed=6)
    batch = {"images": (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8),
             "annos": annos, "valid": valid}
    jbatch = jax.tree.map(jnp.asarray, batch)
    trees = [jax_payload(s0)]           # the step donates its state
    s1, m1 = jt.train_step(s0, jbatch)
    trees.append(jax_payload(s1))
    s2, m2 = jt.train_step(s1, jbatch)
    trees.append(jax_payload(s2))

    tt = TTrainer(tc, device="cpu")
    ps1, pm1 = tt.train_step(load_flax_train_state(tt.init_state(),
                                                   trees[0]), batch)
    ps2, pm2 = tt.train_step(load_flax_train_state(tt.init_state(),
                                                   trees[1]), batch)

    # one f64 gradient of the first step in both packages (train mode,
    # the same normalised input)
    from rrnet_tpu.models.retinanet import RetinaNet as JRetinaNet
    x = ((batch["images"].astype(np.float32) / 255.0
          - np.float32(jc.train.mean)) / np.float32(jc.train.std))
    v0 = {"params": trees[0]["params"], "batch_stats": trees[0]["batch_stats"]}
    with jax.enable_x64(True):
        jm64 = JRetinaNet(backbone="resnet10", dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v0)

        def loss(params):
            o, _ = jm64.apply({"params": params,
                               "batch_stats": v64["batch_stats"]},
                              x.astype(np.float64), train=True,
                              mutable=["batch_stats"])
            return jt._losses(o, jnp.asarray(annos), jnp.asarray(valid),
                              jnp.int32(0))[0]
        jg64 = numpy_state_from_flax({"params": jax.tree.map(
            np.asarray, jax.jit(jax.grad(loss))(v64["params"]))})
    tm64 = as_float64(load_flax_variables(t_build(tc, device="cpu"),
                                          v0)).train()
    o64 = tm64(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).double())
    total64, _ = tt._losses(o64, torch.from_numpy(annos),
                            torch.from_numpy(valid), torch.tensor(0))
    total64.backward()
    tg64 = {k: p.grad.numpy() for k, p in tm64.named_parameters()}
    return dict(metrics=[(jax.tree.map(np.asarray, m1), pm1),
                         (jax.tree.map(np.asarray, m2), pm2)],
                states=[(trees[1], ps1), (trees[2], ps2)],
                jg64=jg64, tg64=tg64, lr=tc.train.lr)


def test_train_step_losses_match_jax(steps):
    for m, pm in steps["metrics"]:
        assert sorted(pm) == sorted(m) == ["cls", "reg", "skipped", "total"]
        for k in m:
            np.testing.assert_allclose(float(pm[k]), m[k], rtol=1e-4,
                                       atol=1e-4 * abs(float(m["total"])),
                                       err_msg=k)
        assert m["skipped"] == 0 and m["cls"] > 0 and m["reg"] > 0


def test_train_step_every_gradient_in_f64(steps):
    jg, tg = steps["jg64"], steps["tg64"]
    assert sorted(tg) == sorted(jg)
    for k in jg:
        close(tg[k], jg[k], rtol=1e-6, what=k)
    assert np.abs(tg["loc.out.weight"]).max() > 0
    assert np.abs(tg["backbone.conv1.weight"]).max() > 0


@pytest.mark.parametrize("which", [0, 1])
def test_train_step_params_match_jax(steps, which):
    tree, ps = steps["states"][which]
    lr = steps["lr"]
    want = numpy_state_from_flax({"params": tree["params"],
                                  "batch_stats": tree["batch_stats"]})
    got = ps.state_dict()
    assert sorted(got) == sorted(want)
    worst, n_far, n = 0.0, 0, 0
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(), err_msg=k)
            continue
        err = np.abs(g - w) / lr
        worst = max(worst, float(err.max()))
        n_far += int((err > 1e-2).sum())
        n += err.size
    assert worst < 2.0 and n_far <= 1e-2 * n, (worst, n_far, n)
    adam = tree["opt_state"][0]
    assert int(ps.step) == int(tree["step"]) == which + 1
    assert int(ps.count) == int(adam.count) == which + 1
    assert int(ps.sched_count) == int(tree["opt_state"][1].count) == which + 1


def test_inf_batch_leaves_the_state_bitwise():
    tt = TTrainer(tcfg.retinanet_config(**TRAIN), device="cpu")
    state = tt.init_state()
    annos, valid = random_annos(2, 16, 64, seed=7)
    bad = {"images": np.full((2, 64, 64, 3), np.inf, np.float32),
           "annos": annos, "valid": valid}
    before = {k: v.clone() for k, v in state.tensors().items()}
    state, m = tt.train_step(state, bad)
    assert float(m["skipped"]) == 1.0
    for k, v in state.tensors().items():
        assert torch.equal(v, before[k]), k


def test_evaluator_matches_jax_without_host_merge():
    """The preset's protocol (scale 1, no flip, `val.auto_test=False`,
    which RetinaNet's collect does not read) on a batch of three images
    in one 96x128 bucket; the cls out-conv is scaled by 10 to spread the
    scores."""
    jc, tc = jcfg.retinanet_config(**TINY), tcfg.retinanet_config(**TINY)
    jm = j_build(jc)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(2), x, train=False))(
        jnp.zeros((1, 64, 64, 3)))
    v = randomize_bn(v, seed=3)
    out = v["params"]["cls"]["out"]
    out["kernel"] = out["kernel"] * 10.0
    tm = load_flax_variables(t_build(tc, device="cpu"), v)
    je = JEvaluator(jc, v, model=jm, bucket_multiple=32)
    te = TEvaluator(tc, tm, device="cpu", bucket_multiple=32)
    imgs = frames(1)
    want, got = predict_both(je, te, imgs)
    assert_rows_match(got, want)
    assert all(0 < len(g) < 1000 for g in got)
    # no host merge: collect is gather alone
    merged = te.gather(te.dispatch_batch(imgs))
    for a, b in zip(te.predict_batch(imgs), merged):
        np.testing.assert_array_equal(a, b)


def test_retinanet_clis_train_eval_and_gate(tmp_path):
    from rrnet_torch.data import synth as TS
    from rrnet_torch.scripts import auto_eval
    from rrnet_torch.scripts import eval as eval_cli
    from rrnet_torch.scripts import synth_gate
    from rrnet_torch.scripts import train as train_cli
    from rrnet_torch.scripts.eval import load_model

    data = TS.make_synth_dataset(str(tmp_path / "synth"), n_train=2, n_val=2,
                                 sizes=((120, 200), (96, 160)))
    last = train_cli.main(["--config", "retinanet", "--device", "cpu",
                           "--steps", "1", f"data_root={data}",
                           f"log_dir={tmp_path / 'log'}", "log_prefix=rt",
                           "train.batch_size=2", *TINY_CLI])
    assert last.endswith("ckp-1")
    got = eval_cli.main(["--config", "retinanet", "--device", "cpu",
                         "--ckpt", last, "--batch", "2", f"data_root={data}",
                         *TINY_CLI, f"val.result_dir={tmp_path / 'res'}"])
    assert len(os.listdir(got["result_dir"])) == 2
    assert 0.0 <= got["scores"]["ap"] <= 1.0
    step, _, ap = auto_eval.main(
        [f"data_root={data}", *TINY_CLI, "--config", "retinanet",
         "--ckpt-dir", os.path.dirname(last), "--device", "cpu", "--batch",
         "2", "--score-grid", "0.01", "--nms-grid", "0.3"])
    assert step == 1 and 0.0 <= ap <= 1.0
    cfg = tcfg.apply_overrides(tcfg.retinanet_config(), TINY_CLI)
    restored, _ = load_model(cfg, "cpu", last)
    fresh, _ = load_model(cfg, "cpu")
    assert not torch.equal(restored.cls.out.weight, fresh.cls.out.weight)

    result = synth_gate.main(
        ["--family", "retinanet", "--steps", "1", "--batch", "2",
         "--device", "cpu", "--dir", str(tmp_path / "gate"), "--out",
         str(tmp_path / "gate.json"), *TINY_CLI])
    row = result["families"][0]
    assert (row["family"], row["seed"]) == ("retinanet", 219)
    assert row["train"]["steps"] == 1 and "stage1_only" not in row
    assert all(0.0 <= row[k] <= 1.0 for k in ("AP", "AP50", "AP75", "AR"))
    assert len(os.listdir(tmp_path / "gate" / "results_retinanet")) == 8
