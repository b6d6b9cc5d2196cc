"""`utils.vis` and `scripts/train.py --log-images` against the JAX
package's `utils/vis.py` (OpenCV).

Boxes: equal pixel for pixel, above the strip, to the JAX drawing with
`with_score=False` (cv2.rectangle, thickness 1), for boxes inside,
partly and wholly outside, reversed, of zero width or height, a point,
and far outside, in xywh and in xyxy rows. Text: the port draws it with
PIL where JAX calls cv2.putText, so its glyphs differ; the check is
looser there: outside each score's text box (11 rows above its baseline
point and 2 below, 40 columns right of it) the image equals JAX's, and
inside it the port has drawn in the box's colour; in the strip, the same
legend entries are drawn (inside each entry's 8-px-a-character span, an
ink pixel of at least half the entry's colour and of its tint, within 3
in every channel: both libraries blend glyph edges), and nothing right
of the last one.
"""

import numpy as np
import pytest

from rrnet_tpu.utils import vis as jvis
from rrnet_torch.data import synth
from rrnet_torch.scripts import train as train_cli
from rrnet_torch.utils import vis as tvis
from torch_threads import one_torch_thread  # noqa: F401

ROWS = np.array([
    [10, 12, 30, 20, 0.91, 4],       # inside
    [-15, 40, 40, 30, 0.35, 1],      # partly outside (left)
    [150, 70, 90, 50, 0.5, 9],       # partly outside (right, bottom)
    [80, 30, -25, -12, 0.77, 6],     # reversed
    [60, 5, 0, 18, 0.6, 2],          # zero width
    [20, 50, 25, 0, 0.4, 10],        # zero height
    [100, 60, 0, 0, 0.3, 3],         # a point
    [-400, -300, 20, 20, 0.2, 5],    # wholly outside
    [-1e5, 10, 3e5, 4e4, 0.25, 7],   # far outside, edges cross the image
], np.float64)


def image(h=90, w=200, seed=0):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("xywh", [True, False])
def test_boxes_equal_cv2_pixel_for_pixel(xywh):
    img = image()
    rows = ROWS.copy()
    if not xywh:      # the same corners as xyxy rows
        rows[:, 2:4] = rows[:, :2] + rows[:, 2:4]
    got = tvis.visualize(img, rows, xywh=xywh)
    want = jvis.visualize(img, rows, xywh=xywh)
    assert got.shape == want.shape == (img.shape[0] + 14, img.shape[1], 3)
    np.testing.assert_array_equal(got[:img.shape[0]], want[:img.shape[0]])
    assert (got[:img.shape[0]] != img).any()
    np.testing.assert_array_equal(img, image())      # the input is kept


def test_rectangle_matches_cv2_on_random_corners():
    import cv2
    rng = np.random.RandomState(1)
    for _ in range(400):
        h, w = rng.randint(1, 30, 2)
        p1 = tuple(int(v) for v in rng.randint(-40, 70, 2))
        p2 = tuple(int(v) for v in rng.randint(-40, 70, 2))
        want = np.zeros((h, w, 3), np.uint8)
        cv2.rectangle(want, p1, p2, (5, 6, 7), 1)
        got = tvis.draw_rectangle(np.zeros((h, w, 3), np.uint8), p1, p2,
                                  (5, 6, 7))
        np.testing.assert_array_equal(got, want)


def test_score_text_and_strip_are_drawn_where_jax_draws_them():
    img = image(seed=2)
    h = img.shape[0]
    got = tvis.visualize(img, ROWS, with_score=True)
    want = jvis.visualize(img, ROWS, with_score=True)
    text = np.zeros(got.shape[:2], bool)
    for row in ROWS[:3]:
        x, y = int(row[0]), max(int(row[1]) - 2, 0)
        text[max(y - 11, 0):y + 3, max(x, 0):max(x + 40, 0)] = True
        color = tvis.TAB20[int(row[5]) % 20].astype(int)
        box = got[max(y - 11, 0):y + 3, max(x, 0):max(x + 40, 0)]
        assert (np.abs(box.astype(int) - color).max(-1) <= 2).any()
    for row in ROWS[3:]:
        x, y = int(row[0]), max(int(row[1]) - 2, 0)
        text[max(y - 11, 0):y + 3, max(x, 0):max(x + 40, 0)] = True
    text[h:] = True
    np.testing.assert_array_equal(got[~text], want[~text])

    strip_t, strip_j = got[h:], want[h:]
    x, spans = 2, []
    for i, name in enumerate(tvis.VISDRONE_CLASS_NAMES[:11]):
        spans.append((i, x, x + 8 * len(name)))
        x += 8 * len(name)
        if x > img.shape[1] - 60:
            break
    for i, x0, x1 in spans:
        color = tvis.TAB20[i].astype(float)
        for strip in (strip_t, strip_j):     # both blend their glyphs
            part = strip[:, x0:x1].reshape(-1, 3).astype(float)
            alpha = part @ color / (color @ color)
            tinted = np.abs(part - alpha[:, None] * color).max(-1) <= 3
            assert (tinted & (alpha >= 0.5)).any(), (i, x0)
    assert not strip_t[:, spans[-1][2] + 8:].any()


TINY = ["model.backbone=tiny_hourglass", "model.topk=32",
        "model.stage2_rois=8", "model.dtype=float32",
        "train.crop_size=(64,64)", "train.max_objects=16",
        "train.stage2_warmup_steps=0", "train.num_workers=1",
        "use_tensorboard=False"]


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    return synth.make_synth_dataset(str(tmp_path_factory.mktemp("vis")),
                                    n_train=3, n_val=1)


@pytest.mark.parametrize("config,extra,n_images", [
    ("rrnet", [], 2), ("centernet", [], 2),
    ("rrnet", ["train.transport=yuv420"], 2),
    ("retinanet", ["model.backbone=resnet10"], 0)])
def test_train_log_images(synth_root, tmp_path, monkeypatch, config, extra,
                          n_images):
    """`--log-images` logs the prediction and ground-truth drawings under
    `imgs` at each print_interval for rrnet and centernet (also from
    packed YUV 4:2:0 batches), and none for other families."""
    from rrnet_torch.utils.logger import Logger
    logged = []
    real = Logger.log

    def log(self, data, step):
        logged.append((step, data.get("imgs")))
        real(self, data, step)

    monkeypatch.setattr(Logger, "log", log)
    train_cli.main(["--config", config, "--device", "cpu", "--steps", "2",
                    "--log-images", f"data_root={synth_root}",
                    f"log_dir={tmp_path}", "log_prefix=run",
                    "train.batch_size=2", "train.print_interval=1",
                    *TINY, *extra])
    assert [s for s, _ in logged] == [0, 1]
    for _, imgs in logged:
        assert len(imgs["train"]) == n_images
        for im in imgs["train"]:
            assert im.shape == (64 + 14, 64, 3) and im.dtype == np.float32
            assert 0.0 <= im.min() and im.max() <= 1.0


def test_visualize_batch_draws_the_ground_truth(synth_root):
    """The ground-truth image of `visualize_batch` is `visualize` of the
    batch's first image and valid rows."""
    from rrnet_torch import config as cfglib
    from rrnet_torch.data.loader import TrainLoader
    from rrnet_torch.train import Trainer
    cfg = cfglib.apply_overrides(cfglib.rrnet_config(),
                                 [f"data_root={synth_root}", *TINY])
    trainer = Trainer(cfg, device="cpu")
    loader = TrainLoader(cfg, 2, num_threads=1)
    try:
        batch = loader.get_batch()
    finally:
        loader.close()
    pred, gt = train_cli.visualize_batch(trainer, trainer.init_state(),
                                         batch, cfg)
    rows = batch["annos"][0][batch["valid"][0]][:, :6]
    assert len(rows) > 0
    want = tvis.visualize(batch["images"][0], rows)
    np.testing.assert_array_equal(np.round(gt * 255).astype(np.uint8), want)
    assert trainer.model.training
