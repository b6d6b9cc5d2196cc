"""The `rrnet_hrnetv2_attention` preset's train step, Evaluator and
CLIs, on the CPU, against the JAX package, on the small HRNetV2 (base 8,
stage modules (1, 1, 1), four maps, frozen BN statistics) that both
packages' RRNet build inside the tests (each `models.rrnet.get_backbone`
patched; the JAX package's files do not change). Weights are drawn with
numpy on `jax.eval_shape`'s shapes, every attention `W` nonzero
(tests/test_torch_hrnet.py). Tolerances:
  * two train steps against `rrnet_tpu.train.Trainer` (one-device mesh,
    crop 64, topk 32, 8 ROIs, 16 objects, f32, stage 2 from step 0),
    each of the port's from the JAX state before it: losses rtol 1e-4;
    params within 2 lr and 99% within 1e-2 lr (Adam's first steps move
    an element by ~lr x the sign of its gradient, see
    tests/test_torch_train.py); the backbone's BN statistics bitwise
    what they were on both sides (`norm_eval`), the attention towers'
    and stage 2's moved and within rtol 1e-4;
  * the Evaluator at two of the protocol's scales (auto_test, no flip)
    against the JAX Evaluator: rows matched by `assert_rows_match`
    (boxes 1e-3 px, scores 1e-5);
  * the train, eval and gate CLIs take the preset (a tiny run).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rrnet_torch.models.rrnet as t_rrnet_mod
import rrnet_tpu.models.rrnet as j_rrnet_mod
from rrnet_tpu import config as jcfg
from rrnet_tpu.evallib.infer import Evaluator as JEvaluator
from rrnet_tpu.models import build_model as j_build
from rrnet_tpu.models.backbones.hrnet import _HRNetBase
from rrnet_torch import config as tcfg
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.models import build_model as t_build
from rrnet_torch.models.backbones.hrnetv2 import HRNetV2
from rrnet_torch.train import Trainer as TTrainer
from rrnet_torch.utils.from_flax import (load_flax_train_state,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from tests.test_torch_eval_protocol import (assert_rows_match, frames,
                                            predict_both)
from tests.test_torch_hrnet import (PRESET, SMALL, TINY, configs,
                                    drawn_variables, shape_heads)
from tests.test_torch_train import close, jax_payload, random_annos
from torch_threads import one_torch_thread  # noqa: F401

TRAIN = {**TINY, "train.crop_size": (64, 64), "train.max_objects": 16,
         "train.stage2_warmup_steps": 0}
TINY_CLI = ["model.dtype=float32", "model.topk=32", "model.stage2_rois=8",
            "train.crop_size=(64,64)", "train.max_objects=16",
            "train.num_workers=1", "use_tensorboard=False"]


@contextlib.contextmanager
def small_hrnetv2():
    """Both packages' RRNet builds the small HRNetV2 (base 8, modules
    (1, 1, 1), four maps, frozen BN) for any backbone name."""
    def jax_bb(name, num_stacks=2, bn_axis=None, dtype=None,
               module_name="backbone"):
        return _HRNetBase(last_multi_scale=True, norm_eval=True,
                          bn_axis=bn_axis, dtype=dtype, name=module_name,
                          **SMALL)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_rrnet_mod, "get_backbone", jax_bb)
        mp.setattr(t_rrnet_mod, "get_backbone",
                   lambda name, num_stacks=2, dtype=torch.float32:
                   HRNetV2(dtype=dtype, **SMALL))
        yield


@pytest.fixture(scope="module")
def steps():
    """Two steps of `rrnet_tpu.train.Trainer` and of the port's Trainer
    from the same state (drawn variables with every `W` nonzero, zero
    Adam moments: the state `create_train_state` makes, without its
    jitted init) on one batch."""
    from rrnet_tpu.parallel.mesh import create_mesh, replicate
    from rrnet_tpu.train import Trainer as JTrainer
    from rrnet_tpu.train.state import (TrainState, make_optimizer,
                                       make_schedule)

    jc = jcfg.rrnet_hrnetv2_attention_config(**TRAIN)
    tc = tcfg.rrnet_hrnetv2_attention_config(**TRAIN)
    with small_hrnetv2():
        jt = JTrainer(jc, mesh=create_mesh(jc.mesh, jax.devices()[:1]))
        v0 = drawn_variables(j_build(jc), np.zeros((1, 64, 64, 3),
                                                   np.float32), seed=10)
        v0["params"] = shape_heads(v0["params"])
        params = jax.tree.map(jnp.asarray, v0["params"])
        tx = make_optimizer(jc)
        s0 = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 v0["batch_stats"]),
                        opt_state=tx.init(params), apply_fn=jt.model.apply,
                        tx=tx, schedule=make_schedule(jc))
        s0 = replicate(s0, jt.mesh)       # as `Trainer.init_state` places it
        trees = [jax_payload(s0)]

        tt = TTrainer(tc, device="cpu")
        assert not tt.model.backbone.training and tt.model.attention0.training
        rng = np.random.RandomState(12)
        images = (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8)
        # half the GT boxes are the port's forward's own ROIs (train mode,
        # the same weights): stage 2 has positives
        probe = load_flax_variables(t_build(tc, device="cpu"), v0).train()
        with torch.no_grad():
            fwd = probe(tt.normalise(images))
        annos, valid = random_annos(2, 16, 64, seed=13)
        rois = fwd.rois.numpy() * 4.0
        annos[:, :8, :2] = rois[:, :, :2]
        annos[:, :8, 2:4] = rois[:, :, 2:] - rois[:, :, :2]
        valid[:, :8] = fwd.roi_valid.numpy()
        batch = {"images": images, "annos": annos, "valid": valid}
        jbatch = jax.tree.map(jnp.asarray, batch)
        metrics = []
        s = s0
        for _ in range(2):
            s, m = jt.train_step(s, jbatch)
            trees.append(jax_payload(s))
            metrics.append(jax.tree.map(np.asarray, m))

        # each of the port's steps from the JAX state before it
        port = []
        for tree in trees[:2]:
            ps, pm = tt.train_step(load_flax_train_state(tt.init_state(),
                                                         tree), batch)
            port.append(({k: float(x) for k, x in pm.items()},
                         {k: x.clone() for k, x in ps.state_dict().items()}))
    return dict(trees=trees, metrics=metrics, port=port, lr=tc.train.lr)


def test_train_steps_losses_match_jax(steps):
    for m, (pm, _) in zip(steps["metrics"], steps["port"]):
        assert sorted(pm) == sorted(m) == ["hm", "off", "s2", "skipped",
                                           "total", "wh"]
        for k in m:
            np.testing.assert_allclose(pm[k], m[k], rtol=1e-4,
                                       atol=1e-4 * abs(float(m["total"])),
                                       err_msg=k)
        assert m["skipped"] == 0 and m["s2"] > 0


@pytest.mark.parametrize("which", [0, 1])
def test_train_steps_params_and_frozen_statistics_match_jax(steps, which):
    trees, lr = steps["trees"], steps["lr"]
    want = numpy_state_from_flax({"params": trees[which + 1]["params"],
                                  "batch_stats": trees[which + 1][
                                      "batch_stats"]})
    start = numpy_state_from_flax({"params": trees[which]["params"],
                                   "batch_stats": trees[which][
                                       "batch_stats"]})
    got = {k: v.numpy() for k, v in steps["port"][which][1].items()}
    assert sorted(got) == sorted(want)
    worst, n_far, n, moved = 0.0, 0, 0, set()
    for k, w in want.items():
        g = got[k]
        if k.endswith(("running_mean", "running_var")):
            if k.startswith("backbone."):
                # norm_eval: bitwise what they were, on both sides
                np.testing.assert_array_equal(g, start[k], err_msg=k)
                np.testing.assert_array_equal(w, start[k], err_msg=k)
            else:
                assert not np.array_equal(w, start[k]), k
                moved.add(k.split(".")[0])
                close(g, w, rtol=1e-4, what=k)
            continue
        err = np.abs(g - w) / lr
        worst = max(worst, float(err.max()))
        n_far += int((err > 1e-2).sum())
        n += err.size
    assert moved == {"attention0", "attention1", "head_detector"}
    assert worst < 2.0 and n_far <= 1e-2 * n, (worst, n_far, n)
    # the attention's W and its towers train
    w_name = "attention1.W.weight"
    assert not np.array_equal(got[w_name], start[w_name])
    k_name = "attention0.f_key_conv1.weight"
    assert not np.array_equal(got[k_name], start[k_name])


def test_evaluator_two_scales_match_jax():
    """The preset's protocol (auto_test, no flip) at two of its six
    scales on the small HRNetV2, through both Evaluators."""
    jc, tc = configs(**{"val.scales": (1.0, 1.3)})
    with small_hrnetv2():
        jm = j_build(jc)
        v = drawn_variables(jm, np.zeros((1, 64, 64, 3), np.float32),
                            seed=14)
        v["params"] = shape_heads(v["params"])
        tm = load_flax_variables(t_build(tc, device="cpu"), v)
        je = JEvaluator(jc, v, model=jm, bucket_multiple=32)
        te = TEvaluator(tc, tm, device="cpu", bucket_multiple=32)
        want, got = predict_both(je, te, frames(2))
    assert_rows_match(got, want)
    assert all(len(g) > 8 for g in got)        # rows from both scales


def test_preset_clis_train_eval_and_gate(tmp_path):
    from rrnet_torch.data import synth as TS
    from rrnet_torch.scripts import eval as eval_cli
    from rrnet_torch.scripts import synth_gate
    from rrnet_torch.scripts import train as train_cli
    from rrnet_torch.scripts.eval import load_model

    data = TS.make_synth_dataset(str(tmp_path / "synth"), n_train=2, n_val=2,
                                 sizes=((120, 200), (96, 160)))
    with small_hrnetv2():
        last = train_cli.main(["--config", PRESET, "--device", "cpu",
                               "--steps", "1", f"data_root={data}",
                               f"log_dir={tmp_path / 'log'}", "log_prefix=h",
                               "train.batch_size=2", *TINY_CLI])
        assert last.endswith("ckp-1")
        got = eval_cli.main(["--config", PRESET, "--device", "cpu", "--ckpt",
                             last, "--batch", "2", f"data_root={data}",
                             *TINY_CLI, f"val.result_dir={tmp_path / 'res'}",
                             "val.scales=(1.0,1.2)"])
        assert len(os.listdir(got["result_dir"])) == 2
        assert 0.0 <= got["scores"]["ap"] <= 1.0
        cfg = tcfg.apply_overrides(tcfg.PRESETS[PRESET](), TINY_CLI)
        restored, _ = load_model(cfg, "cpu", last)
        fresh, _ = load_model(cfg, "cpu")
        assert not torch.equal(restored.attention0.W.weight,
                               fresh.attention0.W.weight)

        result = synth_gate.main(
            ["--family", PRESET, "--steps", "1", "--batch", "2", "--device",
             "cpu", "--dir", str(tmp_path / "gate"), "--out",
             str(tmp_path / "gate.json"), *TINY_CLI])
    row = result["families"][0]
    assert (row["family"], row["seed"]) == (PRESET, 219)
    assert row["train"]["steps"] == 1
    assert row["train"]["stage2_warmup_steps"] == 0
    for r in (row, row["stage1_only"], row["zero_delta"]):
        assert all(0.0 <= r[k] <= 1.0 for k in ("AP", "AP50", "AP75", "AR"))
    assert len(os.listdir(tmp_path / "gate" / f"results_{PRESET}")) == 8
