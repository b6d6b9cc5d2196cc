"""The data-parallel entry points on the CPU: `Evaluator(devices=...)`,
`python -m rrnet_torch.scripts.eval --data-parallel` and `python -m
rrnet_torch.scripts.train --multihost` (two gloo ranks as `torchrun`
would start them) on the synthetic set, with the tiny f32 RRNet.

  * An Evaluator over two replicas gives each image the rows a single
    Evaluator gives it within that replica's slice of the batch, within
    1e-5 (f32; the same program on the same slice), and its int8
    calibration keeps the whole batch's absmax per conv.
  * The eval CLI with `--data-parallel` (two CPU replicas; `--batch 3`
    rounded up to 4) writes the same result files, byte for byte, as
    without the flag at batch 4.
  * The train CLI with `--multihost` on two ranks: rank 0 alone logs and
    writes the checkpoint, and a run of 2 steps resumed to 3 writes the
    checkpoint of an uninterrupted 3-step run bit for bit (rank 1's
    restored state takes part in every collective of the resumed step,
    so a rank that resumed otherwise would change it).
"""

import os

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from rrnet_torch.data import synth as TS
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.models import build_model
from rrnet_torch.scripts import eval as eval_cli
from tests import torch_ranks
from torch_threads import one_torch_thread  # noqa: F401

TINY = ["model.backbone=tiny_hourglass", "model.topk=32",
        "model.stage2_rois=8", "model.dtype=float32",
        "train.crop_size=(64,64)", "train.max_objects=16",
        "train.stage2_warmup_steps=0", "train.num_workers=1",
        "use_tensorboard=False", "train.batch_size=2",
        "train.print_interval=1"]
EVAL = ["val.scales=(1.0,)", "val.flip_tta=False"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    # small frames: what is checked does not depend on their size
    return TS.make_synth_dataset(str(tmp_path_factory.mktemp("synth")),
                                 n_train=3, n_val=4,
                                 sizes=((160, 256), (128, 224)))


def tiny_cfg(*extra):
    return tcfg.apply_overrides(tcfg.rrnet_config(), TINY + EVAL +
                                list(extra))


def frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (90 + 7 * i, 150 - 5 * i, 3)).astype(
        np.uint8) for i in range(n)]


def test_evaluator_replicas_match_a_single_evaluator_by_slice():
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu")
    dp = Evaluator(cfg, model, device="cpu", devices=["cpu", "cpu"])
    one = Evaluator(cfg, model, device="cpu")
    assert len(dp._replicas) == 2
    assert dp._replicas[1].model is not dp.model
    imgs = frames(5)
    got = dp.predict_batch(imgs)
    # contiguous slices, the larger first: [0, 3) and [3, 5)
    want = one.predict_batch(imgs[:3]) + one.predict_batch(imgs[3:])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    # fewer images than replicas: the empty slice is left out
    single = dp.predict_batch(imgs[:1])
    np.testing.assert_allclose(single[0], one.predict_batch(imgs[:1])[0],
                               rtol=0, atol=1e-5)


def test_data_parallel_int8_calibration_is_the_whole_batch():
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu")
    dp = Evaluator(cfg, model, device="cpu", devices=["cpu", "cpu"],
                   quantize="int8")
    one = Evaluator(cfg, build_model(cfg, device="cpu"), device="cpu",
                    quantize="int8")
    imgs = frames(4, seed=1)
    got, want = dp.calibrate(imgs), one.calibrate(imgs)
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
    assert all(r._quant_scales == got for r in dp._replicas)


def train_code(root, log_dir, steps, *extra):
    argv = ["--multihost", "--device", "cpu", "--steps", str(steps), *extra,
            f"data_root={root}", f"log_dir={log_dir}", "log_prefix=run",
            *TINY]
    return ("import torch; torch.set_num_threads(2); "
            "from rrnet_torch.scripts import train; "
            f"train.main({argv!r})")


@pytest.fixture(scope="module")
def trained(synth_root, tmp_path_factory):
    """Two-rank runs: 3 steps whole, and 2 steps then resumed to 3."""
    tmp = tmp_path_factory.mktemp("multihost")
    for d in ("whole", "parts", "resumed"):
        os.makedirs(tmp / d)
    whole = torch_ranks.start(train_code(synth_root, tmp / "whole", 3),
                              2, tmp / "whole")
    first = torch_ranks.start(train_code(synth_root, tmp / "parts", 2),
                              2, tmp / "parts")
    outs = {"parts": torch_ranks.wait(first, timeout=240)}
    resumed = torch_ranks.start(
        train_code(synth_root, tmp / "parts", 3, "--resume",
                   str(tmp / "parts" / "run" / "ckp-2")), 2, tmp / "resumed")
    outs["resumed"] = torch_ranks.wait(resumed, timeout=240)
    outs["whole"] = torch_ranks.wait(whole, timeout=240)
    return tmp, outs


def test_multihost_train_rank0_writes_and_resume_is_bitwise(trained):
    tmp, outs = trained
    run = tmp / "parts" / "run"
    assert sorted(os.listdir(run)) == ["ckp-2", "ckp-3", "log.txt"]
    for r0, r1 in (outs["parts"], outs["resumed"], outs["whole"]):
        assert "saved" in r0 and "saved" not in r1
        assert "train/total_loss=" in r0 and "train/total_loss=" not in r1
    assert all("resumed from step 2" in o for o in outs["resumed"])
    a = torch.load(tmp / "whole" / "run" / "ckp-3" / "state.pt",
                   weights_only=True)
    b = torch.load(run / "ckp-3" / "state.pt", weights_only=True)
    assert a.keys() == b.keys() and int(a["step"]) == 3
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k


def test_eval_cli_data_parallel_writes_the_same_files(trained, synth_root,
                                                     tmp_path, monkeypatch):
    ckpt = str(trained[0] / "whole" / "run")

    def run(name, *extra):
        out = eval_cli.main(["--config", "rrnet", "--ckpt", ckpt, "--device",
                             "cpu", "--no-score", *extra,
                             f"data_root={synth_root}",
                             f"val.result_dir={tmp_path / name}",
                             *TINY, *EVAL])
        return {f: open(os.path.join(out["result_dir"], f), "rb").read()
                for f in sorted(os.listdir(out["result_dir"]))}

    assert eval_cli.local_devices("cpu") == ["cpu"]
    plain = run("plain", "--batch", "4")
    monkeypatch.setattr(eval_cli, "local_devices", lambda d: ["cpu", "cpu"])
    split = run("split", "--batch", "3", "--data-parallel")
    assert len(plain) == 4 and plain == split
    assert any(len(v) for v in plain.values())
