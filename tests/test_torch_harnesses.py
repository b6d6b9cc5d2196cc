"""The port's harness scripts, end to end on the CPU at a tiny width:
`stage2_ablation`, `dtype_ap_delta` and `long_train_artifact`, each
through `main(argv)` with its record written under `tmp_path` (and none
at the repo root). The long train's two train processes run the train
CLI inside the test's process.

The ablation's metric is held to the JAX script's own computation
(`scripts/stage2_ablation.py`'s `miou`, restated here on the JAX
package's box ops) on the same outputs: the jittered ROIs of a tiny
RRNet and random deltas, within 1e-6. The long-train summary reads a
fresh and a resumed train process's output, and refuses, with a clean
SystemExit, a missing log, a fresh log that resumed and a resumed log
that did not.
"""

import contextlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu.ops import box as jbox
from rrnet_torch import config as cfglib
from rrnet_torch.data import synth
from rrnet_torch.models import build_model
from rrnet_torch.scripts import dtype_ap_delta, long_train_artifact
from rrnet_torch.scripts import stage2_ablation
from rrnet_torch.scripts import train as train_cli
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["model.backbone=tiny_hourglass", "model.topk=32",
        "model.stage2_rois=8", "model.dtype=float32",
        "train.crop_size=(64,64)", "train.max_objects=16",
        "train.num_workers=1", "use_tensorboard=False"]
SMALL_RUN = ["train.batch_size=2", "val.scales=(0.25,)"]
ROOT_RECORDS = ("STAGE2_ABLATION_torch.json", "DTYPE_DELTA_torch.json",
                "LONG_TRAIN_torch.json")


def root_records():
    return {n: os.path.exists(os.path.join(REPO, n)) and os.path.getmtime(
        os.path.join(REPO, n)) for n in ROOT_RECORDS}


def jax_miou(rois, reg, roi_valid, roi_scores, gt_xyxy, valid, sf):
    """The JAX script's metric (scripts/stage2_ablation.py:130-149)."""
    rois_in = rois * sf
    rois_xywh = jnp.concatenate(
        [rois_in[..., :2], rois_in[..., 2:4] - rois_in[..., :2]], -1)
    full = jbox.decode_boxes(rois_xywh, reg)
    zero = jbox.decode_boxes(rois_xywh, jnp.zeros_like(reg))

    def miou(xywh):
        xyxy = jnp.concatenate(
            [xywh[..., :2], xywh[..., :2] + xywh[..., 2:4]], -1)
        i = jax.vmap(jbox.pairwise_iou)(xyxy, gt_xyxy)
        i = jnp.where(valid[:, None, :], i, 0.0)
        best = jnp.max(i, axis=-1)
        w = roi_valid & (roi_scores > 0.2)
        return jnp.sum(best * w) / jnp.maximum(jnp.sum(w), 1)

    return float(miou(full)), float(miou(zero))


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return synth.make_synth_dataset(str(tmp_path_factory.mktemp("h")),
                                    n_train=3, n_val=2)


def test_ablation_metric_equals_the_jax_scripts(synth_root):
    cfg = cfglib.apply_overrides(cfglib.rrnet_config(),
                                 [f"data_root={synth_root}", *TINY])
    model = build_model(cfg, device="cpu")
    x, gt, valid = stage2_ablation.val_batch(cfg)
    assert x.shape == (2, 3, 64, 64) and gt.shape[:2] == valid.shape
    rng = np.random.RandomState(3)
    jit = (rng.randn(2, 8, 4) * 1.0).astype(np.float32)
    with torch.no_grad():
        outs = model(torch.from_numpy(x), roi_jitter=torch.from_numpy(jit))
    # the model's jittered ROIs, and ROIs near the ground truth (feature
    # coords) so that the IoUs are not all 0
    n = min(8, int(valid.sum(1).min()))
    near = np.zeros((2, 8, 4), np.float32)
    near[:, :n] = gt[:, :n] / 4.0 + rng.randn(2, n, 4).astype(np.float32)
    rois = np.concatenate([outs.rois.numpy(), near], 1)
    roi_valid = np.concatenate([outs.roi_valid.numpy(),
                                np.arange(8)[None].repeat(2, 0) < n], 1)
    reg = (rng.randn(2, 16, 4) * 0.2).astype(np.float32)
    scores = rng.rand(2, 16).astype(np.float32)      # some kept, some not
    args = (rois, reg, roi_valid, scores, gt, valid)
    full, zero = stage2_ablation.mean_best_iou(
        *(torch.from_numpy(np.asarray(a)) for a in args), 4.0)
    wfull, wzero = jax_miou(*(jnp.asarray(a) for a in args), 4.0)
    assert abs(float(full) - wfull) <= 1e-6
    assert abs(float(zero) - wzero) <= 1e-6
    assert wfull != wzero


def test_stage2_ablation_runs(tmp_path):
    before = root_records()
    out = tmp_path / "s2.json"
    result = stage2_ablation.main(
        ["--steps", "2", "--batch", "2", "--device", "cpu",
         "--dir", str(tmp_path / "synth"), "--out", str(out), *TINY])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert [r["jitter_feature_px"] for r in result["rows"]] == \
        [0.0, 0.5, 1.0, 2.0]
    for r in result["rows"]:
        assert 0.0 <= r["stage2_mean_iou"] <= 1.0
        assert r["stage2_gain"] == r["stage2_mean_iou"] - \
            r["zero_delta_mean_iou"]
    assert result["train"]["stage2_warmup_steps"] == 0
    assert root_records() == before


def test_dtype_ap_delta_runs(tmp_path):
    before = root_records()
    out = tmp_path / "dt.json"
    result = dtype_ap_delta.main(
        ["--steps", "2", "--device", "cpu", "--out", str(out),
         "model.backbone=tiny_hourglass", "train.crop_size=(64,64)",
         "train.num_workers=1", "use_tensorboard=False",
         "val.scales=(0.25,)", "val.flip_tta=False"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    for d in ("bfloat16", "float32"):
        assert set(result[d]) == {"ap", "ap50", "ap75", "ar"}
    assert result["ap_delta_f32_minus_bf16"] == (
        result["float32"]["ap"] - result["bfloat16"]["ap"])
    assert root_records() == before


def test_long_train_runs_resumes_and_summarizes(tmp_path, monkeypatch):
    """`--run` at 1/2500 of the protocol: the two train processes run the
    train CLI in this process (their command lines checked, their output
    sent where `run_training` sends it), then the summary."""
    launched = []

    def run(cmd, cwd, stdout, stderr):
        launched.append(cmd)
        with contextlib.redirect_stdout(stdout):
            train_cli.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(long_train_artifact.subprocess, "run", run)
    before = root_records()
    out = tmp_path / "lt.json"
    sched = long_train_artifact.schedule(0.0004)
    assert sched == {"steps": 4, "milestones": (2, 3), "checkpoint": 1,
                     "warmup": 1, "resume": 2}
    result = long_train_artifact.main(
        ["--run", str(tmp_path / "work"), "--scale", "0.0004", "--device",
         "cpu", "--out", str(out), *TINY, *SMALL_RUN,
         "train.print_interval=1"])
    assert [c[:3] for c in launched] == [
        [sys.executable, "-m", "rrnet_torch.scripts.train"]] * 2
    assert "--resume" not in launched[0] and "--resume" in launched[1]
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert result["resumed_from_step"] == 2 and result["final_step"] == 4
    assert result["checkpoints"] == [1, 2, 3, 4]
    assert [r["step"] for r in result["loss_track"]] == [0, 1, 2, 3]
    lr = result["lr_schedule_points"]
    assert lr["0"] > lr["1"] > lr["2"] == lr["3"]     # decays at 2 and 3
    assert "x0.0004" in result["protocol"]
    assert root_records() == before

    work = tmp_path / "work"
    logs = dict(log_dir=str(work / "log" / "RRNetLong"),
                log_a=str(work / "a.log"), log_b=str(work / "b.log"))
    rows = long_train_artifact.parse_log(os.path.join(logs["log_dir"],
                                                      "log.txt"))
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert {"total", "hm", "wh", "off", "s2", "skipped"} <= set(rows[0])

    def summary(**kw):
        paths = {**logs, **kw}
        return long_train_artifact.main(
            ["--log-dir", paths["log_dir"], "--log-a", paths["log_a"],
             "--log-b", paths["log_b"], "--data", str(work / "synth"),
             "--scale", "0.0004", "--device", "cpu",
             "--out", str(tmp_path / "again.json"), *TINY, *SMALL_RUN])

    with pytest.raises(SystemExit, match="no such file"):
        summary(log_a=str(tmp_path / "missing.log"))
    with pytest.raises(SystemExit, match="resumed from step 2"):
        summary(log_a=logs["log_b"])
    with pytest.raises(SystemExit, match="resumed run"):
        summary(log_b=logs["log_a"])


def test_parse_log_reads_the_ports_lines(tmp_path):
    log = tmp_path / "log.txt"
    log.write_text(
        "[00:00:01 < 00:00:09] step 19: train/hm_loss=1.50000 "
        "train/s2_loss=0.25000 train/total_loss=2.00000\n"
        "saved /x/ckp-20\nresumed from step 20\n"
        "[00:00:02 < 00:00:08] step 39: train/hm_loss=nan "
        "train/total_loss=inf train/skipped_loss=1.00000\n")
    rows = long_train_artifact.parse_log(str(log))
    assert rows[0] == {"step": 19, "hm": 1.5, "s2": 0.25, "total": 2.0}
    assert rows[1]["step"] == 39 and np.isnan(rows[1]["hm"])
    assert rows[1]["total"] == float("inf") and rows[1]["skipped"] == 1.0
    assert long_train_artifact.resumed_from(str(log)) == 20
