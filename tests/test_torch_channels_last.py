"""The channels-last eval forward, on the CPU.

`Evaluator._normalize` hands the forward a channels-last input,
`Conv2d.eval_weights` keeps its weights channels-last, and every op of
the body keeps its input's layout. Through `Evaluator.predict_batch`
(two scales, bucket 128 from 96x112 wire frames, so the replicate pad
and the resize run; CenterNet with its fused flip) for `rrnet` on the
tiny hourglass, `rrnet_hrnetv2_attention` on a small HRNetV2,
`centernet` and `retinanet` on ResNet-10, in f32:

  (a) every `Conv2d` takes a channels-last input, and every map the
      backbone (and RetinaNet's FPN) makes is channels-last memory or a
      view into it;
  (b) the forward's outputs equal those of the same weights run in NCHW
      (the input and the cached weights made NCHW-contiguous) within
      `test_torch_conv_bn_fold.py`'s 1e-5, and the rows pair off within
      it (1e-4 px on the boxes); the class logits are spread ten times,
      so that last-bit noise moves no top-k or NMS choice;
  (c) a second batch builds no fold, and a `load_state_dict` (through
      `update_variables`) builds them again, channels-last;
  (d) a train-mode forward takes NCHW everywhere and equals, bit for
      bit, the forward with the nearest resize as it was before (two
      `repeat_interleave`), gradients within 1e-5; an int8 forward gives
      the NCHW run's rows.
"""

import copy

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from rrnet_torch import config as tcfg
from rrnet_torch.evallib import infer
from rrnet_torch.evallib.infer import Evaluator
from rrnet_torch.models import build_model, layers
from rrnet_torch.models import rrnet as t_rrnet_mod
from rrnet_torch.models.backbones import hourglass, hrnet
from rrnet_torch.models.backbones.hrnetv2 import HRNetV2
from rrnet_torch.utils import tracing
from tests.test_torch_conv_bn_fold import (SMALL_HRNET, TOL, counted, flat,
                                           n_bn, randomize)
from torch_threads import one_torch_thread  # noqa: F401

CL = torch.channels_last
MODELS = ["rrnet", "rrnet_hrnetv2_attention", "centernet", "retinanet"]
BACKBONE = {"rrnet": "tiny_hourglass", "rrnet_hrnetv2_attention": "hrnetv2",
            "centernet": "tiny_hourglass", "retinanet": "resnet10"}


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def model_of(name, monkeypatch, seed=1):
    """(config, randomized f32 model on the CPU, in eval mode)."""
    if name == "rrnet_hrnetv2_attention":
        monkeypatch.setattr(t_rrnet_mod, "get_backbone",
                            lambda name, num_stacks=2, dtype=torch.float32:
                            HRNetV2(dtype=dtype, **SMALL_HRNET))
    kv = {"model.backbone": BACKBONE[name], "model.dtype": "float32",
          "val.scales": (1.0, 1.25)}
    if name != "retinanet":
        kv.update({"model.topk": 64, "model.stage2_rois": 16})
    cfg = tcfg.PRESETS[name](**kv)
    model = randomize(build_model(cfg, device="cpu"), seed)
    # class logits spread wide (as tests/test_torch_rrnet.py's), so that
    # last-bit noise reorders no top-k and flips no NMS choice
    with torch.no_grad():
        for m in ([model.cls.out] if name == "retinanet" else
                  [getattr(model.hm, f"out{i}") for i in range(2)]):
            m.weight.mul_(10.0)
    return cfg, model


def frames(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (90, 100, 3)).astype(np.uint8),
            rng.randint(0, 256, (80, 96, 3)).astype(np.uint8)]


def evaluator(cfg, model, **kw):
    return Evaluator(cfg, model, device="cpu", bucket_multiple=64, **kw)


def layouts(monkeypatch):
    """The (H, W) and channels-last flag of each `Conv2d` input, in call
    order, recorded from here on."""
    seen = []
    run = layers.Conv2d.run

    def recorded(self, x, weight, bias):
        seen.append((tuple(x.shape[-2:]), x.is_contiguous(memory_format=CL)))
        return run(self, x, weight, bias)

    monkeypatch.setattr(layers.Conv2d, "run", recorded)
    return seen


def channels_minor(t) -> bool:
    """A 4-D map whose channel stride is the least of its non-unit axes:
    channels-last memory, or a view into it."""
    strides = [st for st, n in zip(t.stride(), t.shape) if n > 1]
    return t.shape[1] == 1 or t.stride(1) == min(strides)


class MapLayouts(TorchFunctionMode):
    """Records every 4-D floating-point map that a torch function returns
    while active and that is not channels-minor."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor) and t.dim() == 4
                    and t.is_floating_point() and not channels_minor(t)):
                self.bad.append((getattr(func, "__name__", str(func)),
                                 tuple(t.shape)))
        return out


def watched(module, mode):
    """Run `mode` over each forward of `module`."""
    def enter(m, args):
        mode.__enter__()

    def leave(m, args, out):
        mode.__exit__(None, None, None)

    return [module.register_forward_pre_hook(enter),
            module.register_forward_hook(leave)]


def nchw(monkeypatch):
    """Run the eval path as it ran before: the input and every cached
    eval weight NCHW-contiguous."""
    normalize, eval_weights = infer.Evaluator._normalize, \
        layers.Conv2d.eval_weights

    def weights(self, bn=None):
        w, b = eval_weights(self, bn)
        return w.clone(memory_format=torch.contiguous_format), b

    monkeypatch.setattr(layers.Conv2d, "eval_weights", weights)
    monkeypatch.setattr(infer.Evaluator, "_normalize",
                        lambda self, staged: normalize(self, staged).clone(
                            memory_format=torch.contiguous_format))


def run(ev, images):
    """(the rows of one batch, each forward's outputs flattened)."""
    outs = []
    h = ev.model.register_forward_hook(
        lambda m, args, out: outs.append(flat(out)))
    try:
        rows = ev.predict_batch(images)
    finally:
        h.remove()
    return rows, outs


def assert_same_rows(rows, want_rows):
    """Each image's rows pair off with the other side's within `TOL`, 1e-4
    absolute on the boxes (input pixels: the stride-4 maps' 1e-5, times
    4, over the scale); rows of near-equal score may trade places."""
    assert [r.shape for r in rows] == [r.shape for r in want_rows]
    for got, want in zip(rows, want_rows):
        tol = TOL["atol"] + TOL["rtol"] * np.abs(want)
        tol[:, :4] += 1e-4
        close = (np.abs(got[:, None] - want[None]) <= tol[None]).all(-1)
        assert close.any(1).all() and close.any(0).all()


@pytest.mark.parametrize("name", MODELS)
def test_every_eval_conv_takes_a_channels_last_input(name, monkeypatch):
    cfg, model = model_of(name, monkeypatch)
    ev = evaluator(cfg, model)
    seen = layouts(monkeypatch)
    x, _ = ev._preprocess(ev._upload(frames()), (128, 128), False)
    assert x.is_contiguous(memory_format=CL) and not x.is_contiguous()
    ev.predict_batch(frames())      # the folds are built
    # every map the backbone (and RetinaNet's FPN) makes keeps the layout
    mode = MapLayouts()
    hooks = [h for mod in (model.backbone, getattr(model, "fpn", None))
             if mod is not None for h in watched(mod, mode)]
    try:
        ev.predict_batch(frames())
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(cl for _, cl in seen), [s for s in seen if not s[1]]
    assert not mode.bad, mode.bad[:5]
    for m in model.modules():
        if isinstance(m, layers.Conv2d) and m._eval is not None:
            assert m._eval[1].is_contiguous(memory_format=CL)


@pytest.mark.parametrize("name", MODELS)
def test_channels_last_equals_the_nchw_forward(name, monkeypatch):
    cfg, model = model_of(name, monkeypatch)
    ev = evaluator(cfg, model)
    rows, outs = run(ev, frames())
    with monkeypatch.context() as m:
        nchw(m)
        seen = layouts(m)
        want_rows, want_outs = run(ev, frames())
    # the reference is NCHW but for stage 2, which aligns its 3x3 ROI
    # features channels-last in both
    assert all(not cl for hw, cl in seen if hw != (3, 3))
    assert len(outs) == len(want_outs) > 0
    for got, want in zip(outs, want_outs):
        torch.testing.assert_close(got, want, **TOL)
    assert_same_rows(rows, want_rows)


def test_the_folds_are_built_once_and_again_after_a_load(monkeypatch):
    cfg, model = model_of("rrnet_hrnetv2_attention", monkeypatch)
    ev = evaluator(cfg, model)
    pairs = n_bn(model)
    _, first = counted(lambda: ev.predict_batch(frames()))
    _, second = counted(lambda: ev.predict_batch(frames(1)))
    assert first["conv_bn.fold_builds"] == pairs
    assert second["conv_bn.fold_builds"] == 0
    assert second["conv_bn.folded"] == first["conv_bn.folded"] > 0
    other = randomize(copy.deepcopy(model), seed=2)
    ev.update_variables(other.state_dict())
    _, third = counted(lambda: ev.predict_batch(frames()))
    assert third["conv_bn.fold_builds"] == pairs
    built = [m._eval[1] for m in model.modules()
             if isinstance(m, layers.Conv2d) and m._eval is not None]
    assert built and all(w.is_contiguous(memory_format=CL) for w in built)


def _old_resize_nearest(x, oh, ow):
    """`hourglass.resize_nearest` as it was before the layout change."""
    h, w = x.shape[-2:]
    if (oh, ow) == (2 * h, 2 * w):
        return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return (x.index_select(-2, hourglass._nearest_index(h, oh, x.device))
            .index_select(-1, hourglass._nearest_index(w, ow, x.device)))


@pytest.mark.parametrize("name", ["rrnet", "rrnet_hrnetv2_attention"])
def test_train_mode_stays_nchw_and_unchanged(name, monkeypatch):
    _, model = model_of(name, monkeypatch)
    model.train()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3))
    ref = copy.deepcopy(model)

    def step(m):
        out = m(x)
        loss = sum(t.float().square().mean() for t in
                   (out.hms[-1], out.whs[-1], out.offsets[-1],
                    out.stage2_reg))
        loss.backward()
        return flat(out), {k: p.grad for k, p in m.named_parameters()
                           if p.grad is not None}

    with monkeypatch.context() as m:
        seen = layouts(m)
        got, grads = step(model)
    # stage 2's ROI features are a channels-last view in training too
    assert seen and all(not cl for hw, cl in seen if hw != (3, 3))
    with monkeypatch.context() as m:
        for mod in (hourglass, hrnet):
            m.setattr(mod, "resize_nearest", _old_resize_nearest)
        want, want_grads = step(ref)
    assert torch.equal(got, want)
    assert grads.keys() == want_grads.keys() and grads
    for k, g in grads.items():
        torch.testing.assert_close(g, want_grads[k], **TOL)


def test_an_int8_forward_gives_the_nchw_rows(monkeypatch):
    cfg, model = model_of("rrnet", monkeypatch)
    ev = evaluator(cfg, model, quantize="int8")
    ev.calibrate(frames())
    rows, outs = run(ev, frames(1))
    with monkeypatch.context() as m:
        nchw(m)
        want_rows, want_outs = run(ev, frames(1))
    for got, want in zip(outs, want_outs):
        torch.testing.assert_close(got, want, **TOL)
    assert_same_rows(rows, want_rows)
