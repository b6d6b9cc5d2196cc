"""The port's eval protocol (rrnet_torch.evallib.infer at several scales
with flip TTA, evallib.host_nms, metrics.auto_evaluate_results, and the
eval and auto-eval CLIs), on the CPU, against the JAX package.

Inputs come from numpy seeds; the tiny RRNet (tiny_hourglass, f32) has
the converted weights of tests/test_torch_rrnet.py. Tolerances:
  * device preprocess (I420 unpack, edge pad, normalise, bilinear
    resize, flip within the valid width) of the same wire rows against
    `Evaluator._build_preprocess` at scales 1.0,
    1.1, 1.3, 1.5 and 0.75 (an axis that shrinks: antialiased) for each
    flip setting: atol 5e-5 on the normalised tensor; the scaled valid
    extents equal; `_flip_valid_width` equal exactly;
  * `predict_batch` at the preset's six scales (auto_test True and
    False) and with flip TTA at two scales (fused and unfused) against
    the JAX Evaluator: rows equal in count and class, boxes within 1e-3
    px, scores within 1e-5; the port's fused flip against its unfused
    flip likewise;
  * the host soft-NMS library (the port's copy of the C++, built by the
    port) against the JAX package's: bit-equal; its numpy plain version
    within rtol 1e-5; a failed build raises;
  * `auto_evaluate_results` over a 3x3 grid: AP, AP50, AP75, AR within
    1e-9; the auto-eval CLI's lines equal the JAX script's;
  * the eval CLI restores a train-CLI checkpoint; its files and AP equal
    `evaluate_split` + `evaluate_results` on the same weights.
"""

import contextlib
import importlib.util
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu.evallib import host_nms as JH
from rrnet_tpu.evallib import metrics as JM
from rrnet_tpu.evallib.infer import Evaluator as JEvaluator
from rrnet_tpu.evallib.infer import StagedBatch as JStagedBatch
from rrnet_tpu.evallib.infer import _flip_valid_width as j_flip
from rrnet_torch import config as tcfg
from rrnet_torch.data import synth as TS
from rrnet_torch.data.loader import ValLoader
from rrnet_torch.evallib import host_nms as TH
from rrnet_torch.evallib import metrics as TM
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.evallib.infer import _flip_valid_width as t_flip
from rrnet_torch.scripts import auto_eval as t_auto_eval
from rrnet_torch.scripts import eval as eval_cli
from rrnet_torch.scripts import train as train_cli
from rrnet_torch.scripts.eval import load_model
from rrnet_torch.utils import native
from tests.test_torch_eval import TINY_TRAIN, _split_dirs
from tests.test_torch_rrnet import REPO, configs, tiny_pair
from torch_threads import one_torch_thread  # noqa: F401

SIX = (1.0, 1.1, 1.2, 1.3, 1.4, 1.5)
BOX_TOL, SCORE_TOL = 1e-3, 1e-5


def frames(seed=0, shapes=((90, 100), (84, 128), (96, 71))):
    """uint8 RGB images of several sizes inside one 96x128 bucket
    (bucket_multiple 32)."""
    rng = np.random.RandomState(seed)
    return [(rng.rand(h, w, 3) * 255).astype(np.uint8) for h, w in shapes]


def assert_rows_match(got, want, box_tol=BOX_TOL, score_tol=SCORE_TOL):
    """Per image: equal row counts, the sorted scores within score_tol,
    and every row matched one to one by a row of the same class whose
    score and box are within the tolerances. Rows whose scores lie within
    score_tol of each other may come in either order (programs of two
    scales can give near-equal scores), so rows are matched, not
    compared by position."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=score_tol, rtol=0)
        used = np.zeros(len(w), bool)
        for row in g:
            ok = (~used & (w[:, 5] == row[5])
                  & (np.abs(w[:, 4] - row[4]) <= score_tol)
                  & (np.abs(w[:, :4] - row[:4]).max(1) <= box_tol))
            assert ok.any(), (row, w[np.abs(w[:, 4] - row[4]) <= 1e-3])
            used[np.argmax(ok)] = True


@pytest.fixture(scope="module")
def pair():
    """(jax model, variables, port model) of the tiny RRNet."""
    return tiny_pair()


@pytest.fixture(scope="module")
def jax_ev(pair):
    """One JAX Evaluator for the module: it caches its programs by
    (bucket, scaled shape, flip, batch, wire shape), so tests share the
    programs they have in common; each test sets `cfg` and `fuse_flip`."""
    jm, v, _ = pair
    return JEvaluator(configs()[0], v, model=jm, bucket_multiple=32)


# ---------------------------------------------------------------------------
# device side: preprocess, flip
# ---------------------------------------------------------------------------

def test_flip_valid_width_matches_jax():
    rng = np.random.RandomState(0)
    img = rng.randn(4, 5, 9, 3).astype(np.float32)          # NHWC
    w_valid = np.array([9, 4, 1, 7], np.int32)
    want = np.asarray(j_flip(jnp.asarray(img), jnp.asarray(w_valid)))
    got = t_flip(torch.from_numpy(img.transpose(0, 3, 1, 2)),
                 torch.from_numpy(w_valid)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], img[2])           # width 1: as is


@pytest.mark.parametrize("flip", [False, True, "both"])
@pytest.mark.parametrize("scale", [1.0, 1.1, 1.3, 1.5, 0.75])
def test_preprocess_matches_jax(pair, jax_ev, scale, flip):
    je, te = _both(pair, jax_ev)
    imgs = frames()
    jst, tst = je._upload(imgs), te._upload(imgs)
    assert jst.bucket == tst.bucket == (96, 128)
    scaled = je._scaled_shape(jst.bucket, scale)
    assert te._scaled_shape(tst.bucket, scale) == scaled
    if scale == 0.75:
        assert scaled == (96, 96)                   # the width shrinks
    # the same wire rows into both (the JAX package packs I420 with
    # OpenCV where it imports, the port with numpy: 1 LSB apart)
    assert jst.tight == tst.tight
    pre = je._build_preprocess(jst.bucket, scaled, flip, jst.tight)
    jx, jv = pre((jnp.asarray(tst.payload.numpy()),),
                 jnp.asarray(jst.hws, jnp.int32))
    tx, tv = te._preprocess(tst, scaled, flip)
    n = len(imgs) * (2 if flip == "both" else 1)
    assert tuple(tx.shape) == (n, 3) + scaled
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tx.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jx), atol=5e-5, rtol=0)


def test_scaled_valid_extent_rounds_in_f32():
    """The scaled valid width is ceil of an f32 product; in f64 it moves
    by a pixel at some widths (here 640 -> 768, ratio 1.2)."""
    from rrnet_torch.evallib.infer import scaled_valid_hw
    hw = np.stack([np.arange(1, 641), np.arange(1, 641)], 1).astype(np.int32)
    got = scaled_valid_hw(torch.from_numpy(hw), (640, 640), (768, 768))
    want = np.ceil(hw.astype(np.float32) * np.float32(768 / 640))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert (np.ceil(hw * (768 / 640)) != want).any()


# ---------------------------------------------------------------------------
# predict_batch against the JAX Evaluator
# ---------------------------------------------------------------------------

def _both(pair, jax_ev, fuse_flip=True, **extra):
    """The module's JAX Evaluator set to these settings, and a port
    Evaluator with them."""
    jc, tc = configs(**extra)
    jax_ev.cfg, jax_ev.fuse_flip = jc, fuse_flip
    return jax_ev, TEvaluator(tc, pair[2], device="cpu", bucket_multiple=32,
                              fuse_flip=fuse_flip)


def dispatch_both(je, te, imgs):
    """Both evaluators' handles for the same wire rows: the port's upload
    fed to both (the JAX package packs I420 with OpenCV where it imports,
    the port with numpy, 1 LSB apart)."""
    tst = te._upload(imgs)
    jst = JStagedBatch((jnp.asarray(tst.payload.numpy()),), tst.bucket,
                       tst.hws, tst.tight)
    return je.dispatch_batch(jst), te.dispatch_batch(tst)


def predict_both(je, te, imgs):
    jh, th = dispatch_both(je, te, imgs)
    return je.collect(jh), te.collect(th)


def test_six_scales_match_jax_with_and_without_host_merge(pair, jax_ev):
    """The rrnet preset's protocol: six scales, then the same programs
    collected with val.auto_test=False (score filter, host soft-NMS)."""
    je, te = _both(pair, jax_ev, **{"val.scales": SIX})
    imgs = frames(1)
    jh, th = dispatch_both(je, te, imgs)
    assert len(th[0]) == len(jh[0]) == 6
    raw_j, raw_t = je.collect(jh), te.collect(th)
    assert_rows_match(raw_t, raw_j)
    merged_cfg = configs(**{"val.scales": SIX, "val.auto_test": False})
    je.cfg, te.cfg = merged_cfg
    merged_j, merged_t = je.collect(jh), te.collect(th)
    assert_rows_match(merged_t, merged_j)
    for raw, merged in zip(raw_t, merged_t):
        assert 0 < len(merged) < len(raw)
        assert (merged[:, 4] > 0.1).all()   # soft_nms.score_threshold


@pytest.mark.parametrize("fuse_flip", [True, False])
def test_flip_tta_matches_jax(pair, jax_ev, fuse_flip):
    extra = {"val.scales": (1.0, 1.3), "val.flip_tta": True}
    je, te = _both(pair, jax_ev, fuse_flip=fuse_flip, **extra)
    imgs = frames(2)
    want, got = predict_both(je, te, imgs)
    assert_rows_match(got, want)
    if fuse_flip:
        unfused = TEvaluator(configs(**extra)[1], pair[2], device="cpu",
                             bucket_multiple=32, fuse_flip=False)
        assert_rows_match(te.predict_batch(imgs), unfused.predict_batch(imgs))


# ---------------------------------------------------------------------------
# host soft-NMS
# ---------------------------------------------------------------------------

def nms_inputs(seed, n=300):
    """(n, 5) xyxy+score f32 rows in clusters, with identical boxes, tied
    scores and zero-area boxes."""
    rng = np.random.RandomState(seed)
    ctr = rng.rand(12, 2) * 200
    xy = ctr[rng.randint(0, 12, n)] + rng.randn(n, 2) * 6
    wh = rng.rand(n, 2) * 30 + 2
    dets = np.concatenate([xy, xy + wh, rng.rand(n, 1)], 1).astype(np.float32)
    dets[10:20] = dets[10]                          # identical boxes
    dets[30:40, 4] = dets[30, 4]                    # tied scores
    dets[50:55, 2] = dets[50:55, 0] - 1.0           # zero area (+1 extents)
    dets[55:60, 2:4] = dets[55:60, 0:2] - 3.0       # negative extents
    return dets


def test_jax_host_library_is_the_native_build():
    assert JH._load() is not None


@pytest.mark.parametrize("method", ["gaussian", "linear", "hard"])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_soft_nms_bit_equal_to_jax(seed, method):
    dets = nms_inputs(seed)
    for nt, thr in ((0.3, 0.001), (0.7, 0.1)):
        got = TH.soft_nms(dets, sigma=0.5, Nt=nt, threshold=thr,
                          method=method)
        want = JH.soft_nms(dets, sigma=0.5, Nt=nt, threshold=thr,
                           method=method)
        assert got.dtype == want.dtype == np.float32 and len(got) > 10
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_hard_nms_and_per_class_bit_equal_to_jax(seed):
    dets = nms_inputs(seed)
    for plus_one in (False, True):
        for eq in (False, True):
            np.testing.assert_array_equal(
                TH.hard_nms_indices(dets, 0.5, plus_one, eq),
                JH.hard_nms_indices(dets, 0.5, plus_one, eq))
    rng = np.random.RandomState(seed + 10)
    xywh = np.concatenate([dets[:, :2], dets[:, 2:4] - dets[:, :2]], 1)
    pred = np.concatenate([xywh, dets[:, 4:5],
                           rng.randint(1, 11, (len(dets), 1))], 1)
    for nt, thr in ((0.7, 0.1), (0.5, 0.01)):
        got = TH.per_class_soft_nms_xywh(pred, Nt=nt, threshold=thr)
        want = JH.per_class_soft_nms_xywh(pred, Nt=nt, threshold=thr)
        assert len(got) > 20
        np.testing.assert_array_equal(got, want)
    assert TH.per_class_soft_nms_xywh(pred[:0]).shape == (0, 6)


@pytest.mark.parametrize("method", ["gaussian", "linear", "hard"])
def test_host_soft_nms_plain_version_matches_library(method):
    rng = np.random.RandomState(7)
    xy = rng.rand(400, 2) * 300
    dets = np.concatenate([xy, xy + rng.rand(400, 2) * 40 + 1,
                           rng.rand(400, 1)], 1).astype(np.float32)
    got = TH._soft_nms_numpy(dets, 0.5, 0.3, 0.001, method)
    want = TH.soft_nms(dets, sigma=0.5, Nt=0.3, threshold=0.001,
                       method=method)
    assert got.shape == want.shape and len(got) > 100
    np.testing.assert_array_equal(got[:, :4], want[:, :4])
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=0)
    merged = TH.per_class_soft_nms_xywh(
        np.concatenate([dets, rng.randint(1, 4, (400, 1))], 1),
        soft_nms_fn=TH._soft_nms_numpy)
    assert len(merged) > 50


def test_failed_host_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", str(tmp_path / "missing" / "g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="cannot run"):
        TH.soft_nms(nms_inputs(0)[:5])
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "host_nms.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    with pytest.raises(RuntimeError, match="failed for host_nms.cpp"):
        native.build_all(["host_nms"], csrc=bad, build_dir=tmp_path / "b2")


# ---------------------------------------------------------------------------
# metrics and CLIs
# ---------------------------------------------------------------------------

def test_auto_evaluate_results_matches_jax(tmp_path):
    pred_dir, gt_dir = _split_dirs(tmp_path, 3)
    for s in (0.01, 0.05, 0.3):
        for n in (0.1, 0.3, 0.5):
            got = TM.auto_evaluate_results(pred_dir, gt_dir, s, n,
                                           verbose=False)
            want = JM.auto_evaluate_results(pred_dir, gt_dir, s, n,
                                            verbose=False)
            assert 0.0 < want["ap"] < 1.0
            for k in ("ap", "ap50", "ap75", "ar"):
                assert abs(got[k] - want[k]) <= 1e-9, (s, n, k)


def _jax_auto_eval_lines(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location(
        "jax_auto_eval_script", os.path.join(REPO, "scripts", "auto_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["auto_eval.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue().splitlines()


def _port_lines(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        best = t_auto_eval.main(argv)
    return out.getvalue().splitlines(), best


def test_auto_eval_cli_grid_matches_jax_script(tmp_path, monkeypatch):
    pred_dir, gt_dir = _split_dirs(tmp_path, 4)
    argv = ["--pred", pred_dir, "--gt", gt_dir]
    lines, best = _port_lines(argv)
    assert lines == _jax_auto_eval_lines(monkeypatch, argv)
    assert len([ln for ln in lines if ln.startswith("score_thr=")]) == 9
    assert lines[-1].startswith("best: ") and best[2] > 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step train-CLI run on a tiny synthetic set (frames of 120x200
    and 96x160, one 128x256 bucket), checkpoints at steps 1 and 2."""
    root = tmp_path_factory.mktemp("proto")
    data = TS.make_synth_dataset(str(root / "synth"), n_train=3, n_val=2,
                                 sizes=((120, 200), (96, 160)))
    last = train_cli.main(
        ["--device", "cpu", "--steps", "2", f"data_root={data}",
         f"log_dir={root / 'log'}", "log_prefix=run", "train.batch_size=2",
         "train.checkpoint_interval=1", *TINY_TRAIN])
    return data, os.path.dirname(last)


def test_eval_cli_restores_a_train_checkpoint(trained, tmp_path):
    data, ckpt_dir = trained
    over = [f"data_root={data}", *TINY_TRAIN, "val.scales=(1.0,1.2)",
            "val.auto_test=False"]
    got = eval_cli.main(["--device", "cpu", "--ckpt", ckpt_dir, "--batch", "2",
                         *over, f"val.result_dir={tmp_path / 'cli'}"])
    cfg = tcfg.apply_overrides(tcfg.rrnet_config(), over)
    model, _ = load_model(cfg, "cpu", os.path.join(ckpt_dir, "ckp-2"))
    ref = TEvaluator(cfg, model, device="cpu").evaluate_split(
        ValLoader(cfg), result_dir=str(tmp_path / "ref"), batch_size=2,
        verbose=False)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(got["result_dir"])) == names and len(names) == 2
    for n in names:
        with open(os.path.join(ref, n), "rb") as a, \
                open(os.path.join(got["result_dir"], n), "rb") as b:
            assert a.read() == b.read()
    want = TM.evaluate_results(ref, os.path.join(data, "val", "annotations"),
                               verbose=False)
    for k in ("ap", "ap50", "ap75", "ar"):
        assert got["scores"][k] == want[k]
    # the restored weights are the checkpoint's, not the seeded ones
    fresh, _ = load_model(cfg, "cpu")
    assert not torch.equal(next(model.parameters()),
                           next(fresh.parameters()))


def test_auto_eval_cli_sweeps_checkpoints(trained):
    data, ckpt_dir = trained
    lines, best = _port_lines(
        [f"data_root={data}", *TINY_TRAIN, "val.scales=(1.0,)",
         "--config", "rrnet", "--ckpt-dir", ckpt_dir, "--device", "cpu",
         "--batch", "2", "--score-grid", "0.01", "0.1", "--nms-grid", "0.3"])
    gt = os.path.join(data, "val", "annotations")
    grid = [ln for ln in lines if ln.startswith("ckp-")]
    assert len(grid) == 4
    for step in (1, 2):
        pred_dir = os.path.join(ckpt_dir, f"auto_eval_{step}")
        assert len(os.listdir(pred_dir)) == 2
        for s in (0.01, 0.1):
            want = JM.auto_evaluate_results(pred_dir, gt, s, 0.3,
                                            verbose=False)
            assert f"ckp-{step} score_thr={s} nms_thr=0.3 " \
                f"AP={want['ap']:.4f}" in grid
    assert lines[-1].startswith("best: ckp-") and best[0] in (1, 2)
