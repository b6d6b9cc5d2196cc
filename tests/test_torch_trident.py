"""The port's trident backbone (rrnet_torch.models.backbones.trident)
against the flax modules of the JAX package, in eval and in train mode.

Variables are built from the flax trees' shapes (`jax.eval_shape` of
`init`) and filled from a numpy seed: kernels ~ N(0, 1/fan_in), BN scale
and running variance ~ U(0.5, 1.5), BN bias and running mean ~
N(0, 0.1), and nonzero offset/mask convs, so that the deformable samples
land off the integer grid. The same numpy inputs and cotangents go
through both packages; the loss is sum_i <out_i, ct_i> / numel(out_i).
Compared: outputs, every parameter's gradient and, in train mode, the
updated running statistics.

Tolerance: rtol 1e-4 with atol 1e-4 x the largest magnitude of the
reference tensor, for f32 convolutions and reductions summed in another
order. The whole 50-layer backbone's train step is also compared in f64
(see the test for why its gradients are).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrnet_tpu.models.backbones import get_backbone as j_get_backbone
from rrnet_tpu.models.backbones import trident as jtri
from rrnet_torch.models import build_backbone
from rrnet_torch.models.backbones import get_backbone as t_get_backbone
from rrnet_torch.models.backbones import trident as ttri
from rrnet_torch.utils.from_flax import (check_state_shapes,
                                         load_flax_variables,
                                         numpy_state_from_flax)


def numpy_variables(shapes, seed, offset_std):
    """Numpy variables for the flax tree of `shapes`; see the module
    docstring for the distributions."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        keys = [str(getattr(k, "key", k)) for k in path]
        name = keys[-1]
        if keys[0] == "batch_stats":
            a = (rng.uniform(0.5, 1.5, s.shape) if name == "var"
                 else rng.randn(*s.shape) * 0.1)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif name == "bias":
            a = rng.randn(*s.shape) * 0.1
        elif any(k.startswith("offset_mask") for k in keys):
            a = rng.randn(*s.shape) * offset_std
        else:
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def nhwc(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def from_nchw(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def as_list(outs):
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def run_jax(jm, variables, x, train, seed, call_kw):
    """(outputs, {torch key: grad}, {torch key: new running stat})."""
    has_bs = "batch_stats" in variables
    bs = variables.get("batch_stats", {})
    jx = ([jnp.asarray(a) for a in x] if isinstance(x, list)
          else jnp.asarray(x))
    eval_kw = {k: False if k == "train" else a for k, a in call_kw.items()}
    shapes = [o.shape for o in as_list(jax.eval_shape(
        lambda: jm.apply(variables, jx, **eval_kw)))]
    cts = [nhwc(seed + i, *s) for i, s in enumerate(shapes)]

    def loss(params, bs):
        v = {"params": params, **({"batch_stats": bs} if has_bs else {})}
        if train and has_bs:
            outs, new = jm.apply(v, jx, mutable=["batch_stats"], **call_kw)
        else:
            outs, new = jm.apply(v, jx, **call_kw), {"batch_stats": bs}
        outs = as_list(outs)
        return (sum(jnp.vdot(o, c) / o.size for o, c in zip(outs, cts)),
                (outs, new))

    grads, (outs, new) = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"], bs)
    grads = numpy_state_from_flax({"params": jax.tree.map(np.asarray, grads)})
    stats = (numpy_state_from_flax(jax.tree.map(np.asarray, dict(new)))
             if has_bs else {})
    return [np.asarray(o) for o in outs], grads, stats, cts


def run_port(tm, variables, x, train, cts):
    load_flax_variables(tm, jax.tree.map(np.asarray, variables))
    tm.train(train)
    tx = [to_nchw(a) for a in x] if isinstance(x, list) else to_nchw(x)
    outs = as_list(tm(tx))
    loss = sum((o * to_nchw(c)).sum() / o.numel() for o, c in zip(outs, cts))
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    stats = {k: b.numpy() for k, b in tm.named_buffers()}
    return [from_nchw(o) for o in outs], grads, stats


def assert_close(got, ref, rel=1e-4, what=""):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * scale, err_msg=what)


def compare(jm, tm, x, train, seed=0, offset_std=0.1, call_kw=None,
            rel=1e-4):
    call_kw = dict(call_kw or {})
    jx = ([jnp.asarray(a) for a in x] if isinstance(x, list)
          else jnp.asarray(x))
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jx, **call_kw))
    v = numpy_variables(shapes, seed, offset_std)
    jouts, jgrads, jstats, cts = run_jax(jm, v, x, train, seed + 100,
                                         call_kw)
    touts, tgrads, tstats = run_port(tm, v, x, train, cts)
    assert len(jouts) == len(touts)
    for i, (a, b) in enumerate(zip(touts, jouts)):
        assert_close(a, b, rel, f"output {i}")
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        assert_close(tgrads[k], jgrads[k], rel, f"grad {k}")
    if train:
        assert sorted(tstats) == sorted(jstats)
        for k in jstats:
            assert_close(tstats[k], jstats[k], rel, f"stat {k}")
    return v


BRANCHES = [nhwc(i, 2, 9, 10, 16) for i in range(3)]


@pytest.mark.parametrize("kernel,stride,deform", [
    (3, 1, False), (3, 2, False), (1, 1, False), (3, 1, True), (3, 2, True)])
def test_shared_conv_matches_flax(kernel, stride, deform):
    jm = jtri.SharedConv(16, kernel=kernel, stride=stride, deform=deform)
    tm = ttri.SharedConv(16, 16, kernel=kernel, stride=stride,
                         deform=deform)
    v = compare(jm, tm, BRANCHES, train=True)
    if deform:   # the samples really left the integer grid
        assert np.abs(v["params"]["offset_mask0"]["kernel"]).max() > 0


@pytest.mark.parametrize("deform,stride,train", [
    (False, 1, False), (False, 1, True), (True, 1, False), (True, 1, True),
    (False, 2, True)])
def test_trident_unit_matches_flax(deform, stride, train):
    xs = [nhwc(10 + i, 2, 8, 9, 64) for i in range(3)]
    jm = jtri.TridentUnit(64, stride=stride, deform=deform)
    tm = ttri.TridentUnit(64, 64, stride=stride, deform=deform)
    compare(jm, tm, xs, train, call_kw={"train": train})


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stride,downsample", [(2, True), (1, False)])
def test_bottleneck_v2_matches_flax(stride, downsample, train):
    cin = 32 if downsample else 64
    x = nhwc(20, 2, 10, 11, cin)
    jm = jtri.BottleneckV2(64, stride=stride, downsample=downsample)
    tm = ttri.BottleneckV2(cin, 64, stride=stride, downsample=downsample)
    compare(jm, tm, x, train, call_kw={"train": train})


# ---------------------------------------------------------------------------
# the whole trires50deform at 2x64x64, f32
# ---------------------------------------------------------------------------

def as_float64(tm):
    """The port's module computing in f64 (its convs are pinned to f32)."""
    tm.double()
    for m in tm.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return tm


@pytest.fixture(scope="module")
def whole():
    """JAX and port results of the full-width trires50deform on one set
    of numpy variables: eval maps and train maps / running stats in f32,
    and the train step (maps, every gradient, running stats) once more in
    f64, where the JAX gradient is computed once."""
    x = nhwc(30, 2, 64, 64, 3)
    jm = j_get_backbone("trires50deform")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    v = numpy_variables(shapes, 31, offset_std=0.02)
    out = {}
    jeval = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    out["jax_eval"] = [np.asarray(o) for o in jeval]
    jtrain, jnew = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, x)
    out["jax_train"] = ([np.asarray(o) for o in jtrain],
                        numpy_state_from_flax(jax.tree.map(np.asarray,
                                                           dict(jnew))))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        out["jax_f64"] = run_jax(jm, v64, x.astype(np.float64), True, 40,
                                 {"train": True})
    tm = t_get_backbone("trires50deform")
    load_flax_variables(tm, v)
    with torch.no_grad():
        out["port_eval"] = [from_nchw(o) for o in tm.eval()(to_nchw(x))]
        outs = tm.train()(to_nchw(x))
        out["port_train"] = ([from_nchw(o) for o in outs],
                             {k: b.numpy() for k, b in tm.named_buffers()})
    out["n_params"] = sum(p.numel() for p in tm.parameters())
    tm64 = t_get_backbone("trires50deform")
    load_flax_variables(tm64, v)
    out["port_f64"] = run_port(as_float64(tm64), v64, x.astype(np.float64),
                               True, out["jax_f64"][3])
    return out


def test_whole_trires50deform_eval_maps(whole):
    shapes = [o.shape for o in whole["jax_eval"]]
    assert shapes == [(2, 16, 16, 256), (2, 8, 8, 512), (6, 4, 4, 1024),
                      (6, 4, 4, 2048)]
    assert whole["n_params"] == 27268884
    for i, (a, b) in enumerate(zip(whole["port_eval"], whole["jax_eval"])):
        assert np.isfinite(a).all()
        assert_close(a, b, 1e-4, f"l{i + 1}")


def test_whole_trires50deform_train_maps_and_running_stats(whole):
    """f32; the maps at 5e-4: train-mode BN divides by the batch std of
    as few as 96 values per channel, which magnifies the f32 rounding of
    the statistics in low-variance channels."""
    (tmaps, tstats), (jmaps, jstats) = whole["port_train"], whole["jax_train"]
    for i, (a, b) in enumerate(zip(tmaps, jmaps)):
        assert_close(a, b, 5e-4, f"l{i + 1}")
    assert sorted(tstats) == sorted(jstats)
    for k in jstats:
        assert_close(tstats[k], jstats[k], 1e-4, f"stat {k}")


def test_whole_trires50deform_every_gradient_in_f64(whole):
    """Every parameter's gradient of the train step, in f64. In f32 the
    whole network's gradients are ill-conditioned at the ReLU kinks: a
    1e-6 perturbation of the input moves some of them by up to 23% (f64,
    measured on these variables), so two f32 implementations that round
    differently flip a few ReLUs and cannot agree tightly. In f64 no ReLU
    flips and the two packages agree to 1e-9 of each gradient's largest
    magnitude."""
    (jmaps, jgrads, jstats, _), (tmaps, tgrads, tstats) = (
        whole["jax_f64"], whole["port_f64"])
    assert sorted(tgrads) == sorted(jgrads)
    assert len(jgrads) == 249
    for k in jgrads:
        assert jgrads[k].dtype == np.float64
        assert_close(tgrads[k], jgrads[k], 1e-9, f"grad {k}")
    for i, (a, b) in enumerate(zip(tmaps, jmaps)):
        assert_close(a, b, 1e-9, f"l{i + 1}")
    for k in jstats:
        assert_close(tstats[k], jstats[k], 1e-9, f"stat {k}")
    # the offset convs of every unit and branch receive a gradient
    for b in range(1, 6):
        for i in range(3):
            g = tgrads[f"layer3_{b}.conv2.offset_mask{i}.weight"]
            assert np.abs(g).max() > 0


# ---------------------------------------------------------------------------
# converter, registry, dtype, entry point
# ---------------------------------------------------------------------------

def flax_shape_tree(name):
    jm = j_get_backbone(name)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    # zero-stride views: the shapes, without the memory
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                        shapes)


@pytest.mark.parametrize("name,n_keys", [("trires50deform", 415),
                                         ("trires101deform", 1180)])
def test_converter_maps_the_full_trident_trees(name, n_keys):
    tree = flax_shape_tree(name)
    converted = numpy_state_from_flax(tree)
    tm = t_get_backbone(name)
    expected = {k: t.shape for k, t in tm.state_dict().items()}
    check_state_shapes(expected, {k: a.shape for k, a in converted.items()})
    assert len(expected) == n_keys
    assert expected["conv1.weight"] == (64, 3, 7, 7)
    assert expected["layer3_1.conv2.weight"] == (256, 256, 3, 3)
    assert expected["layer3_5.conv2.offset_mask2.weight"] == (108, 256, 3, 3)
    assert expected["layer3_1.bn2_1.running_var"] == (256,)


def test_converter_raises_on_a_bad_trident_leaf():
    tree = flax_shape_tree("trires50deform")
    tm = t_get_backbone("trires50deform")
    expected = {k: t.shape for k, t in tm.state_dict().items()}

    def shapes_of(t):
        return {k: a.shape for k, a in numpy_state_from_flax(t).items()}

    def edited(fn):
        t = jax.tree.map(lambda a: a, tree)
        fn(t["params"]["layer3_2"]["conv2"])
        return t

    missing = edited(lambda s: s.pop("offset_mask1"))
    with pytest.raises(ValueError, match="missing"):
        check_state_shapes(expected, shapes_of(missing))
    extra = edited(lambda s: s.update(offset_mask3={
        "kernel": np.zeros((3, 3, 256, 108), np.float32),
        "bias": np.zeros((108,), np.float32)}))
    with pytest.raises(ValueError, match="extra"):
        check_state_shapes(expected, shapes_of(extra))
    wrong = edited(lambda s: s.update(weight=np.zeros((3, 3, 256, 128),
                                                      np.float32)))
    with pytest.raises(ValueError, match="shape mismatch"):
        check_state_shapes(expected, shapes_of(wrong))
    odd = edited(lambda s: s.update(scale=np.zeros((3, 256), np.float32)))
    with pytest.raises(ValueError, match="unmapped"):
        numpy_state_from_flax(odd)


@pytest.mark.parametrize("name,depth,deform", [
    ("trires50", 50, False), ("trires101", 101, False),
    ("trires50deform", 50, True), ("trires101deform", 101, True)])
def test_registry_matches_names_as_the_jax_registry(name, depth, deform):
    jm = j_get_backbone(name)
    assert (jm.depth, jm.deform) == (depth, deform)
    tm = t_get_backbone(name)
    units = (23 if depth == 101 else 6) - 1
    assert sum(isinstance(m, ttri.TridentUnit) for m in tm.modules()) == units
    n_off = sum("offset_mask" in k for k, _ in tm.named_parameters())
    assert n_off == (units * 3 * 2 if deform else 0)


def test_bf16_raises_in_both_packages():
    with pytest.raises(ValueError, match="float32"):
        t_get_backbone("trires50deform", dtype=torch.bfloat16)
    jm = jtri.SharedConv(16)
    xs = [jnp.asarray(b, jnp.bfloat16) for b in BRANCHES]
    with pytest.raises(TypeError):
        jm.init(jax.random.PRNGKey(0), xs)


def test_build_backbone_entry_point(monkeypatch):
    m = build_backbone("trires50deform", device="cpu",
                       generator=torch.Generator().manual_seed(3))
    assert not m.training
    om = m.layer3_1.conv2.offset_mask0
    assert om.weight.abs().max() == 0 and om.bias.abs().max() == 0
    assert m.layer3_1.conv2.weight.abs().max() > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_backbone("trires50deform")
