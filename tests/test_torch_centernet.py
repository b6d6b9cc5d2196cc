"""The port's CenterNet (rrnet_torch.models.centernet, its train step, its
eval branch with flip TTA) and the heatmap helpers, on the CPU, against
the JAX package.

The tiny model (tiny_hourglass, f32, the centernet preset otherwise) has
the JAX model's weights carried across by `utils.from_flax`, BN
statistics drawn at random and the heatmap out-convs scaled by 40 (so
that top-k sees no near-ties). Tolerances:
  * forward, every stack's hm / wh / reg maps: atol 1e-4;
  * `peak_nms`, `gather_feat`, `gather_map_at`: equal;
  * the train step against `rrnet_tpu.train.Trainer` (one-device mesh,
    crop 64, 16 objects): losses rtol 1e-4 (f32 convolutions summed in
    another order); the first and second step from the same JAX state:
    params within 2 lr of the JAX step's and 99.5% within 1e-2 lr (see
    tests/test_torch_train.py for why in units of lr), BN statistics
    rtol 1e-4, counts and step equal;
  * the Evaluator at the preset's flip TTA (fused) at scales 1.0 and 1.3
    against the JAX Evaluator, the same wire rows into both: rows equal
    in count and class, boxes within 1e-3 px, scores within 1e-5 (the
    RRNet tolerances); the port's unfused flip against its fused flip.
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
from rrnet_tpu.ops import heatmap as JHM
from rrnet_torch import config as tcfg
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.models import build_model as t_build
from rrnet_torch.models.centernet import CenterNet
from rrnet_torch.ops import heatmap as THM
from rrnet_torch.train import Trainer as TTrainer
from rrnet_torch.utils.from_flax import (load_flax_train_state,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from tests.test_torch_eval_protocol import (assert_rows_match, frames,
                                            predict_both)
from tests.test_torch_layers import randomize_bn
from tests.test_torch_train import jax_payload, random_annos
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"model.backbone": "tiny_hourglass", "model.dtype": "float32"}
TRAIN = {**TINY, "train.crop_size": (64, 64), "train.max_objects": 16}


def configs(**extra):
    kv = {**TINY, **extra}
    return jcfg.centernet_config(**kv), tcfg.centernet_config(**kv)


def spread_hm(params, scale=40.0):
    for name, p in params["hm"].items():
        if name.startswith("out"):
            p["kernel"] = p["kernel"] * scale


@pytest.fixture(scope="module")
def pair():
    """(jax model, variables, port model) with the same weights."""
    jc, tc = configs()
    jm = j_build(jc)
    v = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 64, 64, 3)))
    v = randomize_bn(v, seed=1)
    spread_hm(v["params"])
    tm = load_flax_variables(t_build(tc, device="cpu"), v)
    return jm, v, tm


def test_preset_and_build():
    jc, tc = jcfg.centernet_config(), tcfg.centernet_config()
    assert tc == tcfg.PRESETS["centernet"]()
    for key in ("log_prefix",):
        assert getattr(tc, key) == getattr(jc, key) == "CenterNet"
    assert tc.model.name == "centernet" and not tc.model.sync_bn
    assert tc.val.flip_tta and tc.val.scales == jc.val.scales
    assert isinstance(t_build(configs()[1], device="cpu"), CenterNet)


def test_forward_matches_jax(pair):
    jm, v, tm = pair
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    for g_maps, w_maps in zip(got, want):            # hm, wh, reg
        assert len(g_maps) == len(w_maps) == 2       # every stack
        for g, w in zip(g_maps, w_maps):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=0)


def test_heatmap_helpers_match_jax():
    rng = np.random.RandomState(3)
    hm = rng.rand(2, 3, 9, 11, 4).astype(np.float32)
    hm[0, 0, 2:4, 2:4, 1] = 2.0                      # a plateau: all peaks
    hm[1, 2, :, :, 3] = 0.5                          # a flat channel
    np.testing.assert_array_equal(THM.peak_nms(torch.from_numpy(hm)).numpy(),
                                  np.asarray(JHM.peak_nms(jnp.asarray(hm))))
    np.testing.assert_array_equal(
        THM.peak_nms(torch.from_numpy(hm[0]), kernel=5).numpy(),
        np.asarray(JHM.peak_nms(jnp.asarray(hm[0]), kernel=5)))
    fmap = rng.randn(2, 9, 11, 3).astype(np.float32)
    ind = rng.randint(0, 99, (2, 17)).astype(np.int32)
    np.testing.assert_array_equal(
        THM.gather_map_at(torch.from_numpy(fmap), torch.from_numpy(ind)).numpy(),
        np.asarray(JHM.gather_map_at(jnp.asarray(fmap), jnp.asarray(ind))))
    feat = fmap.reshape(2, 99, 3)
    np.testing.assert_array_equal(
        THM.gather_feat(torch.from_numpy(feat), torch.from_numpy(ind)).numpy(),
        np.asarray(JHM.gather_feat(jnp.asarray(feat), jnp.asarray(ind))))


# ---------------------------------------------------------------------------
# the train step against rrnet_tpu.train.Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps():
    from rrnet_tpu.parallel.mesh import create_mesh
    from rrnet_tpu.train import Trainer as JTrainer

    jc, tc = jcfg.centernet_config(**TRAIN), tcfg.centernet_config(**TRAIN)
    jt = JTrainer(jc, mesh=create_mesh(jc.mesh, jax.devices()[:1]))
    s0 = jt.init_state()
    params = jax.tree.map(np.asarray, s0.params)
    spread_hm(params)
    # placed as the step's own outputs are, so the second step reuses the
    # first step's program
    s0 = s0.replace(params=jax.tree.map(
        lambda a, ref: jax.device_put(a, ref.sharding), params, s0.params))
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
    return dict(metrics=[(jax.tree.map(np.asarray, m1), pm1),
                         (jax.tree.map(np.asarray, m2), pm2)],
                states=[(trees[1], ps1), (trees[2], ps2)], lr=tc.train.lr)


def test_train_step_losses_match_jax(steps):
    for m, pm in steps["metrics"]:
        assert sorted(pm) == sorted(m) == ["hm", "off", "skipped", "total",
                                           "wh"]
        for k in m:
            np.testing.assert_allclose(float(pm[k]), m[k], rtol=1e-4,
                                       atol=1e-4 * abs(float(m["total"])),
                                       err_msg=k)
        assert m["skipped"] == 0 and m["hm"] > 0 and m["wh"] > 0


@pytest.mark.parametrize("which", [0, 1])
def test_train_step_params_match_jax(steps, which):
    """The first step, and the second from the JAX package's state after
    its first, each within the lr-unit bounds of the module docstring."""
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
    assert worst < 2.0 and n_far <= 5e-3 * n, (worst, n_far, n)
    adam = tree["opt_state"][0]
    assert int(ps.step) == int(tree["step"]) == which + 1
    assert int(ps.count) == int(adam.count) == which + 1
    assert int(ps.sched_count) == int(tree["opt_state"][1].count) == which + 1


# ---------------------------------------------------------------------------
# eval with the preset's flip TTA
# ---------------------------------------------------------------------------

def test_flip_tta_eval_matches_jax(pair):
    jm, v, tm = pair
    jc, tc = configs(**{"val.scales": (1.0, 1.3)})
    assert jc.val.flip_tta and tc.val.flip_tta
    je = JEvaluator(jc, v, model=jm, bucket_multiple=32)
    te = TEvaluator(tc, tm, device="cpu", bucket_multiple=32)
    imgs = frames(4)
    want, got = predict_both(je, te, imgs)
    assert_rows_match(got, want)
    # 250 rows per image, program and flip, minus masked-out ones
    assert all(0 < len(g) <= 2 * 2 * 250 for g in got)
    unfused = TEvaluator(tc, tm, device="cpu", bucket_multiple=32,
                         fuse_flip=False)
    assert_rows_match(unfused.predict_batch(imgs), te.predict_batch(imgs))


# ---------------------------------------------------------------------------
# the CLIs with --config centernet / --family centernet
# ---------------------------------------------------------------------------

def test_centernet_clis_train_eval_and_gate(tmp_path):
    from rrnet_torch.data import synth as TS
    from rrnet_torch.scripts import eval as eval_cli
    from rrnet_torch.scripts import synth_gate
    from rrnet_torch.scripts import train as train_cli
    from tests.test_torch_eval import TINY_TRAIN

    data = TS.make_synth_dataset(str(tmp_path / "synth"), n_train=2, n_val=2,
                                 sizes=((120, 200), (96, 160)))
    last = train_cli.main(["--config", "centernet", "--device", "cpu",
                           "--steps", "1", f"data_root={data}",
                           f"log_dir={tmp_path / 'log'}", "log_prefix=ct",
                           "train.batch_size=2", *TINY_TRAIN])
    assert last.endswith("ckp-1")
    got = eval_cli.main(["--config", "centernet", "--device", "cpu",
                         "--ckpt", last, "--batch", "2", f"data_root={data}",
                         *TINY_TRAIN, "val.scales=(1.0,)",
                         f"val.result_dir={tmp_path / 'res'}"])
    assert len(os.listdir(got["result_dir"])) == 2
    assert 0.0 <= got["scores"]["ap"] <= 1.0

    out = tmp_path / "gate.json"
    result = synth_gate.main(
        ["--family", "centernet", "--steps", "1", "--batch", "2",
         "--device", "cpu", "--dir", str(tmp_path / "gate"), "--out",
         str(out), *TINY_TRAIN])
    row = result["families"][0]
    assert (row["family"], row["seed"]) == ("centernet", 219)
    assert "stage1_only" not in row and row["train"]["steps"] == 1
    assert "over_seeds" in result and not result["over_seeds"]
    # rows of two more runs added (a row a run, sorted by seed), and the
    # summary over the three
    other = dict(row, seed=218, AP=row["AP"] + 0.3)
    again = dict(row, AP=row["AP"] + 0.15)
    merged = synth_gate.merge(dict(result, families=[again, other]), str(out))
    assert [(r["seed"], r["AP"]) for r in merged["families"]] == [
        (218, row["AP"] + 0.3), (219, row["AP"]), (219, row["AP"] + 0.15)]
    summary = merged["over_seeds"]["centernet"]
    assert summary["seeds"] == [218, 219, 219]
    assert summary["centernet"]["AP"]["mean"] == pytest.approx(
        row["AP"] + 0.15)
    assert summary["centernet"]["AP"]["spread"] == pytest.approx(0.3)
