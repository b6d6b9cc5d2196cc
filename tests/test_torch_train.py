"""The port's train step (rrnet_torch.train, ops.targets, losses) against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:
  * targets, losses, criterions, schedule: f32 elementwise work in the
    same order, rtol 1e-5 (1e-6 for the schedule and Adam, whose only
    differences are XLA's and torch's pow/sqrt roundings);
  * the whole tiny train step (tiny_hourglass, crop 64, topk 32, 8 ROIs,
    16 objects, f32, stage-1 soft-NMS, stage 2 on from step 0) against
    `rrnet_tpu.train.Trainer` on a one-device mesh: losses rtol 1e-4 (f32
    convolutions summed in another order); ROI classes and validity equal
    and boxes within 1e-3 px (the hm out-conv kernels are scaled by 40 so
    that top-k and NMS see no near-ties); every gradient compared in f64,
    within 1e-6 of its largest magnitude, because f32 gradients are
    ill-conditioned at ReLU kinks (the losses cast the maps to f32 in both
    packages, so the f64 gradients carry f32 rounding of the loss terms);
  * a second step from a JAX state carried across by `from_flax`: params
    within 1e-2 lr of the JAX step's (see the test for why the bound is
    stated in units of lr), moments within 1e-2 of their largest magnitude
    (they hold the step's f32 gradient, whose elements differ by up to
    ~1e-2 of the largest between the packages through ReLUs at their
    kinks), BN statistics rtol 1e-4, counts and step equal.
The JAX step is compiled once, in a module-scoped fixture. JAX is
imported only inside the tests, so the file collects where it is absent.
"""

import numpy as np
import pytest
import torch

from rrnet_torch import config as tcfg
from rrnet_torch import losses as tlosses
from rrnet_torch.models import build_model as t_build
from rrnet_torch.ops import targets as ttargets
from rrnet_torch.train import Trainer as TTrainer
from rrnet_torch.train import criterions as tcrit
from rrnet_torch.train.schedule import multistep_lr as t_multistep_lr
from rrnet_torch.train.state import Layout, TrainState
from rrnet_torch.utils import checkpoint as tckpt
from rrnet_torch.utils.from_flax import (load_flax_train_state,
                                         load_flax_variables,
                                         numpy_state_from_flax)
from torch_threads import one_torch_thread  # noqa: F401

TINY = {"model.backbone": "tiny_hourglass", "model.topk": 32,
        "model.stage2_rois": 8, "model.dtype": "float32",
        "model.nms_type_for_stage1": "soft_nms", "train.crop_size": (64, 64),
        "train.max_objects": 16, "train.stage2_warmup_steps": 0}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rtol=1e-5, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * scale, err_msg=what)


def random_annos(b, n, hw, seed, p_valid=0.8):
    """VisDrone rows: boxes of 1-24 px, some partly outside the crop, a
    few of zero width, classes 1..10; valid mask with padding."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * (hw + 8) - 6
    wh = rng.rand(b, n, 2) * 23 + 1
    wh[:, ::7, 0] = 0.0
    cls = rng.randint(1, 11, (b, n, 1)).astype(np.float32)
    one = np.ones((b, n, 1), np.float32)
    annos = np.concatenate([xy, wh, one, cls, one, one], -1)
    valid = rng.rand(b, n) < p_valid
    return annos.astype(np.float32), valid


# ---------------------------------------------------------------------------
# targets, losses, criterions, schedule
# ---------------------------------------------------------------------------

def test_gaussian_radius_matches_jax():
    import jax.numpy as jnp
    from rrnet_tpu.ops.targets import gaussian_radius
    rng = np.random.RandomState(0)
    h, w = rng.rand(2, 200).astype(np.float32) * 60
    close(ttargets.gaussian_radius(t(h), t(w)).numpy(),
          gaussian_radius(jnp.asarray(h), jnp.asarray(w)))


@pytest.mark.parametrize("agnostic", [False, True])
def test_render_batch_matches_jax(agnostic):
    import jax.numpy as jnp
    from rrnet_tpu.ops.targets import render_batch
    annos, valid = random_annos(3, 70, 64, seed=1)
    want = render_batch(jnp.asarray(annos), jnp.asarray(valid),
                        feat_shape=(16, 16), scale_factor=4, num_classes=10,
                        class_agnostic=agnostic)
    got = ttargets.render_batch(t(annos), t(valid), (16, 16), 4, 10,
                                class_agnostic=agnostic)
    close(got.hm.numpy(), want.hm, what="hm")
    # the positives of the focal loss are the exact 1.0 centres
    np.testing.assert_array_equal(got.hm.numpy() == 1.0,
                                  np.asarray(want.hm) == 1.0)
    assert (got.hm.numpy() == 1.0).sum() > 20
    for name in ("wh", "offset", "reg_mask"):
        close(getattr(got, name).numpy(), getattr(want, name), what=name)
    np.testing.assert_array_equal(got.ind.numpy(), np.asarray(want.ind))


def test_losses_match_jax():
    import jax.numpy as jnp
    from rrnet_tpu import losses as jl
    rng = np.random.RandomState(2)
    logits = (rng.randn(2, 8, 9, 10) * 3).astype(np.float32)
    gt = rng.rand(2, 8, 9, 10).astype(np.float32) ** 4
    gt[0, 1, 2, 3] = gt[1, 4, 5, 6] = 1.0
    pj = jl.clamped_sigmoid(jnp.asarray(logits))
    pt = tlosses.clamped_sigmoid(t(logits))
    close(pt.numpy(), pj)
    close(tlosses.focal_loss_hm(pt, t(gt)).numpy(),
          jl.focal_loss_hm(pj, jnp.asarray(gt)))
    gt0 = gt * 0.5                            # no positives: raw neg sum
    close(tlosses.focal_loss_hm(pt, t(gt0)).numpy(),
          jl.focal_loss_hm(pj, jnp.asarray(gt0)))
    pm = rng.randn(2, 8, 9, 2).astype(np.float32)
    mask = (rng.rand(2, 6) > 0.3).astype(np.float32)
    ind = rng.randint(0, 72, (2, 6)).astype(np.int32)
    tgt = rng.randn(2, 6, 2).astype(np.float32)
    close(tlosses.reg_l1_loss(t(pm), t(mask), t(ind), t(tgt)).numpy(),
          jl.reg_l1_loss(jnp.asarray(pm), jnp.asarray(mask),
                         jnp.asarray(ind), jnp.asarray(tgt)))
    a, b = rng.randn(2, 50).astype(np.float32) * 2
    for red in ("mean", "sum", "none"):
        close(tlosses.smooth_l1_loss(t(a), t(b), reduction=red).numpy(),
              jl.smooth_l1_loss(jnp.asarray(a), jnp.asarray(b),
                                reduction=red))


class _Outs:
    """The fields of RRNetOutputs the stage-2 criterion reads."""

    def __init__(self, rois, roi_valid, stage2_reg):
        self.rois, self.roi_valid, self.stage2_reg = rois, roi_valid, \
            stage2_reg


def test_criterions_match_jax():
    import jax
    import jax.numpy as jnp
    from rrnet_tpu.train import criterions as jc
    rng = np.random.RandomState(3)
    annos, valid = random_annos(2, 12, 64, seed=4)
    hms = [(rng.randn(2, 16, 16, 10) * 2).astype(np.float32)
           for _ in range(2)]
    whs = [rng.randn(2, 16, 16, 2).astype(np.float32) for _ in range(2)]
    offs = [rng.rand(2, 16, 16, 2).astype(np.float32) for _ in range(2)]
    jt = jc.centernet_targets(jnp.asarray(annos), jnp.asarray(valid),
                              (16, 16), 4, 10)
    tt = tcrit.centernet_targets(t(annos), t(valid), (16, 16), 4, 10)
    want = jc.centernet_criterion([jnp.asarray(a) for a in hms],
                                  [jnp.asarray(a) for a in whs],
                                  [jnp.asarray(a) for a in offs], jt)
    got = tcrit.centernet_criterion([t(a) for a in hms], [t(a) for a in whs],
                                    [t(a) for a in offs], tt)
    for k in ("hm", "wh", "off"):
        close(got[k].numpy(), want[k], what=k)

    # stage 2: ROIs near half of the GT boxes (IoU > 0.5), the rest random
    gt = annos[..., :4] / 4.0
    rois = np.concatenate([gt[:, :6, :2], gt[:, :6, :2] + gt[:, :6, 2:]],
                          -1) + rng.randn(2, 6, 4).astype(np.float32) * 0.2
    xy = rng.rand(2, 4, 2) * 14
    rois = np.concatenate([rois, np.concatenate(
        [xy, xy + rng.rand(2, 4, 2) * 4], -1)], 1).astype(np.float32)
    roi_valid = rng.rand(2, 10) > 0.2
    reg = rng.randn(2, 10, 4).astype(np.float32)

    def jloss(r):
        return jc.rrnet_stage2_criterion(
            _Outs(jnp.asarray(rois), jnp.asarray(roi_valid), r),
            jnp.asarray(annos), jnp.asarray(valid), 4)
    wl, wg = jax.value_and_grad(jloss)(jnp.asarray(reg))
    treg = t(reg).requires_grad_()
    gl = tcrit.rrnet_stage2_criterion(_Outs(t(rois), t(roi_valid), treg),
                                      t(annos), t(valid), 4)
    gl.backward()
    assert float(gl.detach()) > 0
    close(gl.detach().numpy(), wl)
    close(treg.grad.numpy(), wg)


@pytest.mark.parametrize("warmup,method", [(0, "linear"), (7, "linear"),
                                           (7, "constant")])
def test_schedule_matches_jax(warmup, method):
    import jax.numpy as jnp
    from rrnet_tpu.train.schedule import multistep_lr
    kw = dict(base_lr=2.5e-4, milestones=(5, 12), gamma=0.1,
              warmup_steps=warmup, warmup_factor=1.0 / 3.0,
              warmup_method=method)
    js, ts = multistep_lr(**kw), t_multistep_lr(**kw)
    for step in range(20):
        close(ts(torch.tensor(step)).numpy(), js(jnp.int32(step)), rtol=1e-6,
              what=str(step))
    # the PyTorch-1.1 order: update 4 already uses the first decay
    assert float(ts(4)) == pytest.approx(2.5e-5, rel=1e-6) or warmup


def test_adam_matches_optax_and_skips_exactly():
    """The port's fused Adam against optax.adam step by step (model:
    tests/test_train_step.py::test_fused_adam_matches_optax)."""
    import jax
    import jax.numpy as jnp
    import optax
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(32).astype(np.float32),
              "b": {"w": rng.randn(4, 4).astype(np.float32)}}
    layout = Layout(params=(("a", (32,)), ("b.w", (4, 4))), stats=())

    def tsched(c):
        return 2.5e-4 * (0.5 ** (c // 3))

    jsched = lambda c: 2.5e-4 * (0.5 ** (c // 3))  # noqa: E731
    tx = optax.adam(jsched, b1=0.9, b2=0.999, eps=1e-8)
    ref = jax.tree.map(jnp.asarray, params)
    opt = tx.init(ref)
    st = TrainState.from_tensors(
        layout, {"a": t(params["a"]), "b.w": t(params["b"]["w"])}, {},
        schedule=tsched, device="cpu")
    for i in range(7):
        g = {"a": rng.randn(32).astype(np.float32),
             "b": {"w": rng.randn(4, 4).astype(np.float32)}}
        flat = torch.cat([t(g["a"]), t(g["b"]["w"]).reshape(-1)])
        st.apply_gradients(flat, good=torch.tensor(True))
        upd, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, ref)
        ref = optax.apply_updates(ref, upd)
        p = st.params()
        close(p["a"].numpy(), ref["a"], rtol=1e-6)
        close(p["b.w"].numpy(), ref["b"]["w"], rtol=1e-6)
    assert int(st.count) == int(opt[0].count) == 7
    assert int(st.sched_count) == int(st.step) == 7

    before = {k: v.clone() for k, v in st.tensors().items()}
    st.apply_gradients(torch.ones(48), good=torch.tensor(False))
    for k, v in st.tensors().items():
        assert torch.equal(v.view(torch.int32) if v.is_floating_point()
                           else v, before[k].view(torch.int32)
                           if v.is_floating_point() else before[k]), k


# ---------------------------------------------------------------------------
# the whole tiny train step against rrnet_tpu.train.Trainer
# ---------------------------------------------------------------------------

def jax_payload(state):
    """The JAX TrainState as numpy (the checkpoint payload's layout)."""
    import jax
    return jax.tree.map(np.asarray, {
        "step": state.step, "params": state.params,
        "batch_stats": state.batch_stats, "opt_state": state.opt_state})


def as_float64(tm):
    """The port's module computing in f64 (its convs are pinned to f32)."""
    tm.double()
    for m in tm.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return tm


@pytest.fixture(scope="module")
def steps():
    """Two JAX train steps and the port's on the same states and batch,
    the f32 train-mode forward of both, and one f64 gradient of both."""
    import jax
    import jax.numpy as jnp
    from rrnet_tpu import config as jcfg
    from rrnet_tpu.models import build_model as j_build
    from rrnet_tpu.models.rrnet import RRNet as JRRNet
    from rrnet_tpu.parallel.mesh import create_mesh
    from rrnet_tpu.train import Trainer as JTrainer

    jc, tc = jcfg.rrnet_config(**TINY), tcfg.rrnet_config(**TINY)
    jt = JTrainer(jc, mesh=create_mesh(jc.mesh, jax.devices()[:1]))
    s0 = jt.init_state()
    params = jax.tree.map(np.asarray, s0.params)
    for name, p in params["hm"].items():
        if name.startswith("out"):       # spread the logits: no near-ties
            p["kernel"] = p["kernel"] * 40.0
    s0 = s0.replace(params=jax.tree.map(jnp.asarray, params))
    tree0 = jax_payload(s0)
    v0 = {"params": tree0["params"], "batch_stats": tree0["batch_stats"]}

    rng = np.random.RandomState(5)
    images = (rng.rand(2, 64, 64, 3) * 255).astype(np.uint8)
    x = ((images.astype(np.float32) / 255.0 - np.float32(jc.train.mean))
         / np.float32(jc.train.std)).astype(np.float32)
    jm = j_build(jc)
    fwd, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                           mutable=["batch_stats"]))(v0, x)
    # half of the GT boxes are this forward's own ROIs, so that stage 2
    # has positives (IoU 1) and its loss and gradient are not 0
    annos, valid = random_annos(2, 16, 64, seed=6)
    rois = np.asarray(fwd.rois) * 4.0
    annos[:, :8, :2] = rois[:, :, :2]
    annos[:, :8, 2:4] = rois[:, :, 2:] - rois[:, :, :2]
    valid[:, :8] = np.asarray(fwd.roi_valid)
    batch = {"images": images, "annos": annos, "valid": valid}
    jbatch = jax.tree.map(jnp.asarray, batch)

    s1, m1 = jt.train_step(s0, jbatch)
    tree1 = jax_payload(s1)
    m1 = jax.tree.map(np.asarray, m1)
    batch2 = batch
    s2, m2 = jt.train_step(s1, jax.tree.map(jnp.asarray, batch2))
    tree2, m2 = jax_payload(s2), jax.tree.map(np.asarray, m2)

    tt = TTrainer(tc, device="cpu")
    outs = []
    hook = tt.model.register_forward_hook(lambda m, a, o: outs.append(o))
    ps = load_flax_train_state(tt.init_state(), tree0)
    ps, pm1 = tt.train_step(ps, batch)
    ps2 = load_flax_train_state(tt.init_state(), tree1)
    ps2, pm2 = tt.train_step(ps2, batch2)
    hook.remove()

    # one f64 gradient of the same step in both packages
    with jax.enable_x64(True):
        jm64 = JRRNet(num_classes=10, num_stacks=2,
                      backbone="tiny_hourglass", topk=32, stage2_rois=8,
                      nms_type="soft_nms", dtype=jnp.float64)
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
    o64 = tm64(t(x.transpose(0, 3, 1, 2)).double())
    total64, _ = tt._losses(o64, t(annos), t(valid), torch.tensor(0))
    total64.backward()
    tg64 = {k: p.grad.numpy() for k, p in tm64.named_parameters()}
    return dict(m1=m1, m2=m2, pm1=pm1, pm2=pm2, fwd=fwd, outs=outs,
                tree1=tree1, tree2=tree2, ps=ps, ps2=ps2, jg64=jg64,
                tg64=tg64, lr=tc.train.lr)


def test_tiny_step_losses_match_jax(steps):
    for m, pm in ((steps["m1"], steps["pm1"]), (steps["m2"], steps["pm2"])):
        assert sorted(pm) == sorted(m) == ["hm", "off", "s2", "skipped",
                                           "total", "wh"]
        for k in m:
            close(float(pm[k]), m[k], rtol=1e-4, what=k)
        assert m["skipped"] == 0
    assert steps["m1"]["s2"] > 0        # stage 2 had positives


def test_tiny_step_roi_selection_matches_jax(steps):
    want, got = steps["fwd"], steps["outs"][0]
    np.testing.assert_array_equal(got.roi_valid.numpy(),
                                  np.asarray(want.roi_valid))
    np.testing.assert_array_equal(got.roi_classes.numpy(),
                                  np.asarray(want.roi_classes))
    np.testing.assert_allclose(got.rois.detach().numpy(),
                               np.asarray(want.rois), atol=1e-3, rtol=0)
    close(got.roi_scores.numpy(), want.roi_scores, rtol=1e-4)
    assert got.roi_valid.sum() >= 4
    for a, b in zip(got.hms, want.hms):
        close(a.detach().numpy(), b, rtol=1e-4)


def test_tiny_step_every_gradient_in_f64(steps):
    jg, tg = steps["jg64"], steps["tg64"]
    assert sorted(tg) == sorted(jg)
    for k in jg:
        close(tg[k], jg[k], rtol=1e-6, what=k)
    # the wh and offset heads get gradient through the ROI coordinates
    # (stage 2) as well as through their L1 losses
    assert np.abs(tg["head_detector.regressor.weight"]).max() > 0


def test_tiny_second_step_from_carried_jax_state(steps):
    """Adam divides each gradient by the root of its second moment, so an
    update moves by lr x the gradient's own relative error: an element
    whose f32 gradient differs by 1e-3 of itself between the packages (a
    ReLU at its kink flips, a small gradient rounds otherwise) moves by
    1e-3 lr, and one near 0 by up to ~lr either way. The bound on the
    params is therefore stated in units of lr: all within 2 lr of the JAX
    step's, and 99.5% within 1e-2 lr. A wrong bias correction or rate
    would move most elements by a good part of lr."""
    tree2, ps2, lr = steps["tree2"], steps["ps2"], steps["lr"]
    want = numpy_state_from_flax({"params": tree2["params"],
                                  "batch_stats": tree2["batch_stats"]})
    got = ps2.state_dict()
    assert sorted(got) == sorted(want)
    worst, n_far, n = 0.0, 0, 0
    for k, w in want.items():
        g = got[k].numpy()
        if k.endswith(("running_mean", "running_var")):
            close(g, w, rtol=1e-4, what=k)
            continue
        err = np.abs(g - w) / lr
        worst = max(worst, float(err.max()))
        n_far += int((err > 1e-2).sum())
        n += err.size
    assert worst < 2.0 and n_far <= 5e-3 * n, (worst, n_far, n)
    adam = tree2["opt_state"][0]
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want_m = numpy_state_from_flax({"params": tree})
        got_m = dict(zip(("mu", "nu"), ps2.moments()))[name]
        for k, w in want_m.items():
            close(got_m[k].numpy(), w, rtol=1e-2, what=f"{name} {k}")
    assert int(ps2.step) == int(tree2["step"]) == 2
    assert int(ps2.count) == int(adam.count) == 2
    assert int(ps2.sched_count) == int(tree2["opt_state"][1].count) == 2


# ---------------------------------------------------------------------------
# the port's trainer on its own: skip, transports, checkpoint, refusals
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    tr = TTrainer(tcfg.rrnet_config(**TINY), device="cpu")
    annos, valid = random_annos(2, 16, 64, seed=8)
    images = (np.random.RandomState(9).rand(2, 64, 64, 3) * 255).astype(
        np.uint8)
    return tr, {"images": images, "annos": annos, "valid": valid}


def bits(state):
    return {k: (v.view(torch.int32) if v.is_floating_point() else v).clone()
            for k, v in state.tensors().items()}


def test_nonfinite_batch_skips_exactly(tiny):
    tr, batch = tiny
    st = tr.init_state(generator=torch.Generator().manual_seed(3))
    st, m = tr.train_step(st, batch)
    before = bits(st)
    bad = dict(batch, images=np.full((2, 64, 64, 3), np.inf, np.float32))
    st, m = tr.train_step(st, bad)
    assert float(m["skipped"]) == 1.0 and not np.isfinite(float(m["total"]))
    after = bits(st)
    for k in before:
        assert torch.equal(before[k], after[k]), k
    st, m = tr.train_step(st, batch)
    assert float(m["skipped"]) == 0.0 and int(st.step) == 2


def test_loss_and_grads_leaves_the_state(tiny):
    tr, batch = tiny
    st = tr.init_state()
    before = bits(st)
    total, grads = tr.loss_and_grads(st, batch)
    assert np.isfinite(float(total))
    assert sorted(grads) == sorted(st.params())
    assert all(torch.equal(before[k], v) for k, v in bits(st).items())


def test_transports_match_jax_normalisation(tiny):
    import jax.numpy as jnp
    from rrnet_tpu.data.yuv420 import pack_yuv420, unpack_yuv420_device
    tr, batch = tiny
    images = batch["images"]
    mean = np.float32(tr.cfg.train.mean)
    std = np.float32(tr.cfg.train.std)
    want = (images.astype(np.float32) / 255.0 - mean) / std
    close(tr.normalise(images).permute(0, 2, 3, 1).numpy(), want)
    packed = pack_yuv420(images)
    wyuv = (np.asarray(unpack_yuv420_device(jnp.asarray(packed), 64, 64))
            / 255.0 - mean) / std
    close(tr.normalise(packed).permute(0, 2, 3, 1).numpy(), wyuv)
    f = want.astype(np.float32)
    assert torch.equal(tr.normalise(f).permute(0, 2, 3, 1), t(f))


def test_checkpoint_round_trip(tiny, tmp_path):
    tr, batch = tiny
    st = tr.init_state()
    for step in range(3):
        st, _ = tr.train_step(st, batch)
        tckpt.save_checkpoint(str(tmp_path), st, keep=2)
    assert tckpt.available_steps(str(tmp_path)) == [2, 3]
    fresh = tr.init_state(generator=torch.Generator().manual_seed(11))
    tckpt.restore_checkpoint(str(tmp_path), fresh)
    for k, v in bits(st).items():
        assert torch.equal(v, bits(fresh)[k]), k
    # the restored state trains on exactly as the original
    _, m_a = tr.train_step(st, batch)
    _, m_b = tr.train_step(fresh, batch)
    assert float(m_a["total"]) == float(m_b["total"])
    other = TTrainer(tcfg.rrnet_config(**dict(TINY, **{
        "model.stage2_rois": 4, "model.num_stacks": 1})), device="cpu")
    with pytest.raises(ValueError, match="another model"):
        tckpt.restore_checkpoint(str(tmp_path), other.init_state(), step=2)


def test_train_state_converter_raises_on_unmapped_leaves(tiny):
    tr, _ = tiny
    st = tr.init_state()
    tree = {"step": np.int32(0), "params": {}, "batch_stats": {},
            "opt_state": ({"count": 0, "mu": {}, "nu": {}}, {"count": 0})}
    with pytest.raises(ValueError, match="missing"):
        load_flax_train_state(st, tree)
    with pytest.raises(ValueError, match="unmapped train state"):
        load_flax_train_state(st, dict(tree, extra=1))
    with pytest.raises(ValueError, match="unmapped Adam state"):
        load_flax_train_state(st, dict(tree, opt_state=(
            {"count": 0, "mu": {}}, {"count": 0})))


def test_trainer_refusals(monkeypatch):
    with pytest.raises(NotImplementedError):
        TTrainer(tcfg.rrnet_config(**{"model.name": "ssd"}),
                 device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTrainer(tcfg.rrnet_config(**TINY))
