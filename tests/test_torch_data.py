"""The port's data pipeline (rrnet_torch.data, utils.timer, utils.logger)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed, or are the synthetic set the JAX
package's generator writes, and go through both packages. Tolerances:
  * `_resize_image` (numpy) against the JAX package's `cv2.resize`:
    uint8 bilinear and nearest bit-exact; float32 bilinear bit-exact on
    the pipeline's shapes, and on sources under 40 px within 2e-6 (the
    sweep below measures 1.04e-6 on values in [0, 1]: OpenCV sends some
    narrow sources down another path);
  * transforms under the same `np.random.Generator`: annotations exact,
    images within 1e-6 (fill_duck resizes small patches), the generator
    left in the same state;
  * `train_pipeline`'s uint8 crops within 1 LSB, annotations exact;
  * `TrainLoader(num_threads=1)` over 3 batches across an epoch boundary:
    images within 1 LSB, annotations and masks exact;
  * `make_synth_dataset`: annotation files byte-identical, images and
    roadmaps within 1 LSB.
JAX-package modules are imported inside the tests, so the file collects
where they are absent (the `cuda` case runs on the card without them).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from rrnet_torch.data import jpeg
from rrnet_torch.data import loader as TL
from rrnet_torch.data import synth as TS
from rrnet_torch.data import transforms as TT
from rrnet_torch.data import visdrone as TV
from rrnet_torch.utils.logger import Logger
from rrnet_torch.utils.timer import Timer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    """The JAX package's synthetic set, 3 train + 2 val images."""
    from rrnet_tpu.data.synth import make_synth_dataset
    return make_synth_dataset(str(tmp_path_factory.mktemp("synth")),
                              n_train=3, n_val=2)


def configs(data_root):
    from rrnet_tpu import config as jcfg
    kv = {"data_root": data_root}
    return jcfg.rrnet_config(**kv), tcfg.rrnet_config(**kv)


def sample(synth_dir, idx=0):
    """Train sample `idx` read by the JAX package's reader."""
    from rrnet_tpu.data.visdrone import VisDroneDataset
    return VisDroneDataset(synth_dir, "train", with_road_map=True)[idx]


def assert_samples_equal(got, want, atol=0.0):
    np.testing.assert_array_equal(got["annos"], want["annos"])
    np.testing.assert_allclose(got["image"], want["image"], atol=atol, rtol=0)
    assert (got.get("roadmap") is None) == (want.get("roadmap") is None)
    if want.get("roadmap") is not None:
        np.testing.assert_array_equal(got["roadmap"], want["roadmap"])


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

RESIZE_CASES = {"up": ((540, 960), (621, 1104)),
                "down": ((64, 80), (30, 41)),
                "odd": ((37, 53), (71, 90)),
                "multi_scale": ((512, 896), (768, 1344))}


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
@pytest.mark.parametrize("mode", ["linear_f32", "linear_u8", "nearest_f32"])
def test_resize_matches_cv2(mode, case):
    from rrnet_tpu.data.transforms import _resize_image
    (h, w), (oh, ow) = RESIZE_CASES[case]
    rng = np.random.default_rng(0)
    if mode == "linear_u8":
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif mode == "linear_f32":
        img = rng.random((h, w, 3), dtype=np.float32)
    else:                               # roadmaps: 2-D float32
        img = rng.random((h, w), dtype=np.float32)
    nearest = mode == "nearest_f32"
    want = _resize_image(img, (ow, oh), nearest=nearest)
    got = TT._resize_image(img, (ow, oh), nearest=nearest)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_small_sources_gap():
    """200 random sizes, sources 1-39 px, targets 1-59 px: uint8 and
    nearest bit-exact; float32 within 2e-6 on values in [0, 1] (measured:
    22 of the 200 cases differ, by at most 1.04e-6, which 25 pixels
    reach)."""
    from rrnet_tpu.data.transforms import _resize_image
    rng = np.random.default_rng(8)
    gap, cases, at_gap = 0.0, 0, 0
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        oh, ow = (int(v) for v in rng.integers(1, 60, 2))
        f = rng.random((h, w, 3), dtype=np.float32)
        u = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        d = np.abs(TT._resize_image(f, (ow, oh)) - _resize_image(f, (ow, oh)))
        if d.max() > gap:
            gap, at_gap = float(d.max()), 0
        at_gap += int((d == gap).sum()) if gap else 0
        cases += bool(d.max())
        np.testing.assert_array_equal(TT._resize_image(u, (ow, oh)),
                                      _resize_image(u, (ow, oh)))
        np.testing.assert_array_equal(
            TT._resize_image(f[..., 0], (ow, oh), nearest=True),
            _resize_image(f[..., 0], (ow, oh), nearest=True))
    print(f"f32 gap {gap:.3g} in {cases} cases, {at_gap} pixels at it")
    assert gap <= 2e-6, (gap, cases, at_gap)


def test_resize_refuses_what_it_does_not_copy():
    with pytest.raises(ValueError):
        TT._resize_image(np.zeros((4, 4), np.float32), (0, 3))
    with pytest.raises(TypeError):
        TT._resize_image(np.zeros((4, 4), np.float64), (3, 3))


# ---------------------------------------------------------------------------
# reader and JPEG
# ---------------------------------------------------------------------------

def test_reader_matches_jax(synth_dir, tmp_path):
    from rrnet_tpu.data.visdrone import VisDroneDataset, parse_annotation_file
    for split, road in (("train", True), ("val", False)):
        j = VisDroneDataset(synth_dir, split, with_road_map=road)
        t = TV.VisDroneDataset(synth_dir, split, with_road_map=road)
        assert t.names == j.names
        for i in range(len(j)):
            a, b = t[i], j[i]
            assert a["name"] == b["name"]
            assert_samples_equal(a, b)
    odd = tmp_path / "odd.txt"
    odd.write_text("1,2,3,4,1,4,0,0,\n\n5,6,7,8,1,11,0,0\n9,10,11,12,0,3\n")
    np.testing.assert_array_equal(TV.parse_annotation_file(str(odd)),
                                  parse_annotation_file(str(odd)))
    (tmp_path / "empty.txt").write_text("")
    assert TV.parse_annotation_file(str(tmp_path / "empty.txt")).shape == (0, 8)
    assert TV.VISDRONE_CLASS_NAMES[11] == "others"


def test_jpeg_round_trip_and_grayscale(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:96, 0:128]
    img = np.clip(np.stack([xx * 2, yy * 2, xx + yy], -1)
                  + rng.normal(0, 2, (96, 128, 3)), 0, 255).astype(np.uint8)
    path = str(tmp_path / "a.jpg")
    jpeg.encode(path, img, quality=92)
    back = jpeg.decode(path)
    assert back.shape == img.shape and back.dtype == np.uint8
    mse = np.mean((back.astype(np.float64) - img) ** 2)
    assert 10 * np.log10(255.0 ** 2 / mse) >= 38.0
    np.testing.assert_array_equal(back, np.asarray(Image.open(path).convert("RGB")))
    gray = img[..., 0]
    jpeg.encode(str(tmp_path / "g.jpg"), gray, quality=95)
    g = jpeg.decode(str(tmp_path / "g.jpg"))
    assert g.shape == (96, 128, 3)
    np.testing.assert_array_equal(g[..., 0], g[..., 2])
    np.testing.assert_array_equal(g[..., 0],
                                  np.asarray(Image.open(str(tmp_path / "g.jpg"))))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _call(mod, name, s, rng, cfg):
    t = cfg.train
    if name == "multi_scale":
        return mod.multi_scale(s, rng, t.multi_scales)
    if name == "mask_ignore":
        return mod.mask_ignore(s, t.mean)
    if name == "fill_duck":
        return mod.fill_duck(s, rng, t.fill_duck_classes, t.fill_duck_factor)
    if name == "horizontal_flip":
        return mod.horizontal_flip(s, rng, 0.5)
    if name == "random_crop":
        return mod.random_crop(s, rng, tuple(t.crop_size))
    if name == "random_crop_large_boxes":   # no candidate: the rescale path
        s = dict(s, annos=s["annos"] * np.float32([1, 1, 30, 30, 1, 1, 1, 1]))
        return mod.random_crop(s, rng, (256, 256))
    if name == "random_crop_small_image":    # pads, then crops
        s = dict(s, image=s["image"][:300, :400], roadmap=None)
        return mod.random_crop(s, rng, (320, 512))
    if name == "normalize":
        return mod.normalize(s, t.mean, t.std)
    if name == "denormalize":
        return dict(s, image=mod.denormalize(s["image"], t.mean, t.std))
    if name == "color_jitter":
        return mod.color_jitter(s, rng)
    if name == "val_pipeline":
        return mod.val_pipeline(s, cfg)
    raise KeyError(name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", [
    "multi_scale", "mask_ignore", "fill_duck", "horizontal_flip",
    "random_crop", "random_crop_large_boxes", "random_crop_small_image",
    "normalize", "denormalize", "color_jitter", "val_pipeline"])
def test_transform_matches_jax(synth_dir, name, seed):
    from rrnet_tpu.data import transforms as JT
    jc, tc = configs(synth_dir)
    src = sample(synth_dir, seed % 3)
    if name == "fill_duck":      # as in the pipeline: after MultiScale
        src = JT.multi_scale(src, np.random.default_rng(seed + 10))
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = _call(JT, name, dict(src), rj, jc)
    got = _call(TT, name, dict(src), rt, tc)
    assert_samples_equal(got, want, atol=1e-6)
    assert rt.random() == rj.random()       # the same draws were taken


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_train_pipeline_matches_jax(synth_dir, idx):
    from rrnet_tpu.data import transforms as JT
    jc, tc = configs(synth_dir)
    for seed in range(3):
        want = JT.train_pipeline(sample(synth_dir, idx),
                                 np.random.default_rng(seed), jc)
        got = TT.train_pipeline(sample(synth_dir, idx),
                                np.random.default_rng(seed), tc)
        assert got["image"].dtype == np.uint8 and got["image"].shape == (512, 512, 3)
        np.testing.assert_array_equal(got["annos"], want["annos"])
        d = np.abs(got["image"].astype(int) - want["image"])
        assert d.max() <= 1, d.max()
    want = JT.train_pipeline(sample(synth_dir, idx), np.random.default_rng(0),
                             jc, as_uint8=False)
    got = TT.train_pipeline(sample(synth_dir, idx), np.random.default_rng(0),
                            tc, as_uint8=False)
    assert_samples_equal(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

def test_pad_annotations_matches_jax():
    from rrnet_tpu.data.loader import pad_annotations
    rng = np.random.default_rng(0)
    for n in (0, 5, 40):
        annos = rng.random((n, 8)).astype(np.float32) * 50
        for got, want in zip(TL.pad_annotations(annos, 16),
                             pad_annotations(annos, 16)):
            np.testing.assert_array_equal(got, want)


def test_train_loader_matches_jax_across_an_epoch(synth_dir):
    """Batches of 2 from 3 images: batch 1 holds the first epoch's last
    sample and the second epoch's first."""
    from rrnet_tpu.data.loader import TrainLoader
    jc, tc = configs(synth_dir)
    jl = TrainLoader(jc, 2, num_threads=1)
    tl = TL.TrainLoader(tc, 2, num_threads=1)
    try:
        want = [jl.get_batch() for _ in range(3)]
        got = [tl.get_batch() for _ in range(3)]
    finally:
        jl.close()
        tl.close()
    assert tl.epoch >= 1 and tl.skips == 0
    for g, w in zip(got, want):
        assert g["images"].shape == (2, 512, 512, 3)
        assert np.abs(g["images"].astype(int) - w["images"]).max() <= 1
        np.testing.assert_array_equal(g["annos"], w["annos"])
        np.testing.assert_array_equal(g["valid"], w["valid"])
    # a loader started at sample 2 draws what the first drew from there on
    late = TL.TrainLoader(tc, 2, num_threads=1, start_sample=2)
    try:
        b = late.get_batch()
    finally:
        late.close()
    for k in b:
        np.testing.assert_array_equal(b[k], got[1][k])


class _FlakyDataset:
    """Three copies of one synthetic sample; index 1 always fails."""

    def __init__(self, synth_dir):
        self.item = sample(synth_dir)

    def __len__(self):
        return 3

    def __getitem__(self, idx):
        if idx == 1:
            raise OSError("unreadable sample")
        return dict(self.item)


def test_loader_skips_and_counts_failed_samples(synth_dir, capsys):
    _, tc = configs(synth_dir)
    tl = TL.TrainLoader(tc, 2, dataset=_FlakyDataset(synth_dir),
                        num_threads=2)
    try:
        batch = tl.get_batch()
    finally:
        tl.close()
    assert batch["images"].shape[0] == 2
    assert tl.skips >= 1
    assert "unreadable sample" in capsys.readouterr().out
    with pytest.raises(TL.LoaderClosed):
        tl.get_batch()


def test_yuv420_transport_and_make_loaders(synth_dir):
    from rrnet_torch.data.yuv420 import pack_yuv420
    _, tc = configs(synth_dir)
    rgb_cfg = tc
    yuv_cfg = tcfg.set_by_path(tc, "train.transport", "yuv420")
    a = TL.TrainLoader(rgb_cfg, 2, num_threads=1)
    b = TL.TrainLoader(yuv_cfg, 2, num_threads=1)
    try:
        ra, rb = a.get_batch(), b.get_batch()
    finally:
        a.close()
        b.close()
    assert rb["images"].shape == (2, 512 * 512 * 3 // 2)
    np.testing.assert_array_equal(rb["images"], pack_yuv420(ra["images"]))
    train, val = TL.make_loaders(tcfg.set_by_path(tc, "train.num_workers", 1))
    try:
        assert train.batch_size == tc.train.batch_size
        items = list(val)
    finally:
        train.close()
    assert [i["name"] for i in items] == val.dataset.names and len(items) == 2
    assert items[0]["image"].dtype == np.uint8
    assert items[0]["annos"].shape[1] == 8


def test_val_loader_matches_jax(synth_dir):
    from rrnet_tpu.data.loader import ValLoader
    jc, tc = configs(synth_dir)
    want, got = list(ValLoader(jc)), list(TL.ValLoader(tc))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["annos"], w["annos"])


def test_device_prefetcher_on_the_cpu(synth_dir):
    _, tc = configs(synth_dir)
    ref = TL.TrainLoader(tc, 2, num_threads=1)
    try:
        want = [ref.get_batch() for _ in range(2)]
    finally:
        ref.close()
    pf = TL.DevicePrefetcher(TL.TrainLoader(tc, 2, num_threads=1),
                             device="cpu")
    try:
        got = [pf.get_batch() for _ in range(2)]
    finally:
        pf.close()
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    with pytest.raises(TL.LoaderClosed):
        pf.get_batch()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_prefetcher_on_the_card(cuda_device, tmp_path):
    """Batches staged on a side stream equal the loader's own, read on
    the default stream right after a busy kernel."""
    root = TS.make_synth_dataset(str(tmp_path / "s"), n_train=3, n_val=1)
    cfg = tcfg.rrnet_config(data_root=root)
    ref = TL.TrainLoader(cfg, 2, num_threads=1)
    try:
        want = [ref.get_batch() for _ in range(3)]
    finally:
        ref.close()
    pf = TL.DevicePrefetcher(TL.TrainLoader(cfg, 2, num_threads=1),
                             device=cuda_device)
    try:
        x = torch.randn(4096, 4096, device=cuda_device)
        for w in want:
            x = x @ x / 64.0
            g = pf.get_batch()
            for k in w:
                assert g[k].device.type == "cuda"
                np.testing.assert_array_equal(g[k].cpu().numpy(), w[k])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# synthetic set
# ---------------------------------------------------------------------------

def test_make_synth_dataset_matches_jax(synth_dir, tmp_path):
    ours = TS.make_synth_dataset(str(tmp_path / "t"), n_train=3, n_val=2)
    for split, sub in (("train", "annotations"), ("val", "annotations"),
                       ("train", "images"), ("train", "roadmap"),
                       ("val", "images")):
        a_dir = os.path.join(ours, split, sub)
        b_dir = os.path.join(synth_dir, split, sub)
        names = sorted(os.listdir(b_dir))
        assert sorted(os.listdir(a_dir)) == names and names
        for n in names:
            a, b = os.path.join(a_dir, n), os.path.join(b_dir, n)
            if sub == "annotations":
                assert open(a, "rb").read() == open(b, "rb").read(), n
            else:
                d = np.abs(jpeg.decode(a).astype(int) - jpeg.decode(b))
                assert d.max() <= 1, (n, d.max())


def test_synth_variant_matches_jax():
    from rrnet_tpu.data.synth import _variant
    image = jpeg.decode(os.path.join(REPO, "data", "demo", "images",
                                     "0000364_01765_d_0000782.jpg"))
    annos = TV.parse_annotation_file(os.path.join(
        REPO, "data", "demo", "annotations", "0000364_01765_d_0000782.txt"))
    for seed in range(4):
        out_hw = ((540, 960), (512, 896))[seed % 2]
        wi, wa = _variant(image, annos, np.random.default_rng(seed), out_hw)
        gi, ga = TS._variant(image, annos, np.random.default_rng(seed), out_hw)
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gi, wi)


# ---------------------------------------------------------------------------
# timer, logger, imports
# ---------------------------------------------------------------------------

def test_timer_and_logger(tmp_path, capsys):
    from rrnet_tpu.utils.timer import Timer as JTimer
    t, j = Timer(100), JTimer(100)
    t.start_time = j.start_time = 0.0
    assert t.stamp(10)[:1] == "[" and len(t.stamp(10)) == len(j.stamp(10))
    cfg = tcfg.rrnet_config(log_dir=str(tmp_path), log_prefix="run",
                            use_tensorboard=False)
    log = Logger(cfg)
    log.init_timer(10)
    log.log({"scalar": {"train/total_loss": torch.tensor(1.5)}}, 3)
    log.start_trace()
    torch.ones(8).sum()
    path = log.stop_trace()
    log.close()
    assert "step 3: train/total_loss=1.50000" in capsys.readouterr().out
    text = open(os.path.join(tmp_path, "run", "log.txt")).read()
    assert "train/total_loss=1.50000" in text
    assert os.path.getsize(path) > 0
    quiet = Logger(cfg, main_process=False)
    quiet.log({"scalar": {"x": 1.0}}, 0)
    quiet.close()


def test_data_modules_load_neither_opencv_nor_pil_on_import():
    code = r"""
import sys
import rrnet_torch.data.loader, rrnet_torch.data.synth, rrnet_torch.data.jpeg
import rrnet_torch.evallib.metrics, rrnet_torch.evallib.infer
import rrnet_torch.scripts.train, rrnet_torch.scripts.synth_gate
import rrnet_torch.utils.logger
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("cv2", "PIL", "jax", "rrnet_tpu"))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
