"""The port's split evaluator and AP (rrnet_torch.evallib.writer, .metrics,
`Evaluator.evaluate_split`), its train CLI and its synthetic gate, on the
CPU, against the JAX package.

Tolerances:
  * `save_result`: byte-identical files; `load_result`, `_int_truncate_xywh`
    and `evaluate_results` / `evaluate_once`: equal to 1e-12 (the same
    f64 numpy arithmetic);
  * `evaluate_split` with a tiny RRNet (tiny_hourglass, f32, the same
    converted weights as tests/test_torch_serving.py) over 4 small images
    in one 64x64 bucket at batch 3 (one full batch, one padded): the same
    files with the same rows; classes equal, boxes within 1e-3 px and
    scores within 1e-4 (the serving tolerances) plus the writer's
    rounding (%f and %.4f); AP against ground truth made from the JAX
    package's detections within 1e-3. The port's files also equal its own
    `predict_batch` written by `save_result`, byte for byte;
  * the train CLI at tiny width on the CPU: 2 steps, then `--resume` for 2
    more, leaves a checkpoint bitwise equal to 4 uninterrupted steps.
"""

import json
import os

import numpy as np
import pytest
import torch

from rrnet_tpu.evallib import metrics as JM
from rrnet_tpu.evallib import writer as JW
from rrnet_tpu.evallib.infer import Evaluator as JEvaluator
from rrnet_torch.data import synth as TS
from rrnet_torch.evallib import metrics as TM
from rrnet_torch.evallib import writer as TW
from rrnet_torch.evallib.infer import Evaluator as TEvaluator
from rrnet_torch.scripts import synth_gate, train as train_cli
from tests.test_torch_rrnet import configs, tiny_pair

EVAL = {"val.scales": (1.0,), "val.flip_tta": False}


def predictions(rng, n, hw=(120, 160)):
    """(n, 6) [x, y, w, h, score, cls] rows, some beyond the frame."""
    xy = rng.rand(n, 2) * np.array([hw[1], hw[0]]) - 5
    wh = rng.rand(n, 2) * 30 + 0.5
    return np.concatenate([xy, wh, rng.rand(n, 1),
                           rng.randint(1, 11, (n, 1))], 1)


def test_writer_matches_jax_byte_for_byte(tmp_path):
    rng = np.random.RandomState(0)
    for style in ("rrnet", "centernet"):
        for n in (0, 1, 37):
            pred = predictions(rng, n)
            a, b = tmp_path / f"t_{style}{n}.txt", tmp_path / f"j_{style}{n}.txt"
            TW.save_result(str(a), pred, style=style)
            JW.save_result(str(b), pred, style=style)
            assert a.read_bytes() == b.read_bytes()
            np.testing.assert_array_equal(TW.load_result(str(a)),
                                          JW.load_result(str(b)))
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1,2,3,4,0.5,1,\n5,6,7,8,0.25,2,-1,-1\n\n")
    np.testing.assert_array_equal(TW.load_result(str(ragged)),
                                  JW.load_result(str(ragged)))


def _split_dirs(tmp_path, seed, n_img=6):
    """A prediction dir and a GT dir: GT boxes with ignore regions and
    crowds, predictions that jitter, miss, duplicate and misclassify."""
    rng = np.random.RandomState(seed)
    pred_dir, gt_dir = tmp_path / f"pred{seed}", tmp_path / f"gt{seed}"
    pred_dir.mkdir()
    gt_dir.mkdir()
    for i in range(n_img):
        gt = predictions(rng, 30)
        gt[:, 4] = 1
        gt[:3, 5] = 0                                  # ignore regions
        gt[:3, 2:4] *= 3
        rows = np.concatenate([gt, np.zeros((30, 2))], 1)
        with open(gt_dir / f"im{i}.txt", "w") as f:
            for r in rows:
                f.write(",".join(str(int(round(v))) for v in r) + "\n")
        keep = gt[3:][rng.rand(27) < 0.8]
        pred = keep.copy()
        pred[:, :4] += rng.randn(len(pred), 4) * 2
        pred[:, 4] = rng.rand(len(pred))
        flip = rng.rand(len(pred)) < 0.1
        pred[flip, 5] = rng.randint(1, 11, flip.sum())
        pred = np.concatenate([pred, pred[:4] + 0.5, predictions(rng, 8)])
        TW.save_result(str(pred_dir / f"im{i}.txt"), pred)
    return str(pred_dir), str(gt_dir)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_results_matches_jax(tmp_path, seed):
    pred_dir, gt_dir = _split_dirs(tmp_path, seed)
    got = TM.evaluate_results(pred_dir, gt_dir, verbose=False)
    want = JM.evaluate_results(pred_dir, gt_dir, verbose=False)
    assert 0.05 < want["ap"] < 0.95
    for k in ("ap", "ap50", "ap75", "ar"):
        assert abs(got[k] - want[k]) <= 1e-12, k
    np.testing.assert_allclose(got["ap_per_threshold"],
                               want["ap_per_threshold"], rtol=0, atol=1e-12)
    pred = TW.load_result(os.path.join(pred_dir, "im0.txt"))
    target = TW.load_result(os.path.join(gt_dir, "im0.txt"))
    np.testing.assert_array_equal(TM._int_truncate_xywh(pred),
                                  JM._int_truncate_xywh(pred))
    one_t, one_j = TM.evaluate_once(pred, target), JM.evaluate_once(pred, target)
    for k in ("ap", "ap50", "ap75", "ar"):
        assert abs(one_t[k] - one_j[k]) <= 1e-12, k


class _Split:
    """Four small uint8 images in one 64x64 bucket."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.items = [{"name": f"im{i}",
                       "image": (rng.rand(h, w, 3) * 255).astype(np.uint8),
                       "annos": np.zeros((0, 8), np.float32)}
                      for i, (h, w) in enumerate([(60, 50), (56, 64),
                                                  (64, 64), (48, 40)])]

    def __iter__(self):
        return iter(self.items)


@pytest.fixture(scope="module")
def pair():
    jm, v, tm = tiny_pair(**EVAL)
    jc, tc = configs(**EVAL)
    return jm, v, tm, jc, tc


def test_evaluate_split_matches_jax(pair, tmp_path):
    jm, v, tm, jc, tc = pair
    split = _Split()
    jdir = JEvaluator(jc, v, model=jm, bucket_multiple=64).evaluate_split(
        split, result_dir=str(tmp_path / "j"), batch_size=3, verbose=False)
    tev = TEvaluator(tc, tm, device="cpu", bucket_multiple=64)
    tdir = tev.evaluate_split(split, result_dir=str(tmp_path / "t"),
                              batch_size=3, verbose=False)
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names == [f"im{i}.txt" for i in range(4)]
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    for n in names:
        g = TW.load_result(os.path.join(tdir, n))
        w = JW.load_result(os.path.join(jdir, n))
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3 + 1e-6, rtol=0)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-4 + 1e-4, rtol=0)
        # ground truth: the JAX package's 6 best boxes as the scorer reads
        # them (integer xyxy corners), so they score high
        best = JM._int_truncate_xywh(w[:6])
        rows = np.concatenate([best[:, :4], np.ones((len(best), 1)),
                               best[:, 5:6], np.zeros((len(best), 2))], 1)
        with open(gt_dir / n, "w") as f:
            for r in rows:
                f.write(",".join(str(int(round(x))) for x in r) + "\n")
    ap_t = TM.evaluate_results(tdir, str(gt_dir), verbose=False)
    ap_j = JM.evaluate_results(jdir, str(gt_dir), verbose=False)
    assert ap_j["ap50"] > 0.3
    for k in ("ap", "ap50", "ap75", "ar"):
        assert abs(ap_t[k] - ap_j[k]) <= 1e-3, (k, ap_t[k], ap_j[k])
    # the pipeline's order and padding change nothing: its files are the
    # port's own predict_batch, written by save_result
    imgs = [it["image"] for it in split]
    direct = tev.predict_batch(imgs[:3]) + tev.predict_batch(imgs[3:] * 3)[:1]
    for i, pred in enumerate(direct):
        TW.save_result(str(tmp_path / "direct.txt"), pred)
        assert (tmp_path / "direct.txt").read_bytes() == \
            open(os.path.join(tdir, f"im{i}.txt"), "rb").read()
    # max_images stops early
    few = tev.evaluate_split(split, result_dir=str(tmp_path / "few"),
                             max_images=2, batch_size=3, verbose=False)
    assert sorted(os.listdir(few)) == ["im0.txt", "im1.txt"]


TINY_TRAIN = ["model.backbone=tiny_hourglass", "model.topk=32",
              "model.stage2_rois=8", "model.dtype=float32",
              "train.crop_size=(64,64)", "train.max_objects=16",
              "train.stage2_warmup_steps=0", "train.num_workers=1",
              "use_tensorboard=False"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return TS.make_synth_dataset(str(tmp_path_factory.mktemp("synth")),
                                 n_train=3, n_val=2)


def test_train_cli_resume_is_bitwise(synth_root, tmp_path, capsys):
    def run(name, steps, *extra):
        return train_cli.main(
            ["--device", "cpu", "--steps", str(steps), *extra,
             f"data_root={synth_root}", f"log_dir={tmp_path / name}",
             "log_prefix=run", "train.batch_size=2", "train.print_interval=2",
             *TINY_TRAIN])

    whole = run("whole", 4)
    first = run("parts", 2)
    assert os.path.basename(first) == "ckp-2"
    resumed = run("parts", 4, "--resume", str(tmp_path / "parts" / "run"))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "train/total_loss=" in out
    assert os.path.basename(whole) == os.path.basename(resumed) == "ckp-4"
    a = torch.load(os.path.join(whole, "state.pt"), weights_only=True)
    b = torch.load(os.path.join(resumed, "state.pt"), weights_only=True)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
    assert int(a["step"]) == 4
    log = open(tmp_path / "parts" / "run" / "log.txt").read()
    assert "step 1:" in log and "step 3:" in log


def test_synth_gate_runs_on_the_cpu(tmp_path):
    out = tmp_path / "gate.json"
    result = synth_gate.main(
        ["--steps", "2", "--batch", "2", "--device", "cpu",
         "--dir", str(tmp_path / "synth"), "--out", str(out), *TINY_TRAIN])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    entry = result["families"][0]
    assert entry["family"] == "rrnet" and entry["train"]["steps"] == 2
    assert entry["train"]["loader_skips"] == 0
    for row in (entry, entry["stage1_only"], entry["zero_delta"]):
        assert all(0.0 <= row[k] <= 1.0 for k in ("AP", "AP50", "AP75", "AR"))
    assert len(os.listdir(tmp_path / "synth" / "results_rrnet")) == 8
