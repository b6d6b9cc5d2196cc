"""`utils.convert` against the JAX package's converters.

For every converter, on a reference-layout dict (tests/reference_layouts.py)
with unexpected keys planted: the port's state_dict equals
`from_flax.torch_state_dict_from_flax` of the JAX converter's (params,
batch_stats), key for key and bit for bit, and the reports are equal.
First with every dimension cut to at most 2 (the key mapping), then at
the real shapes of ResNet-50, a 1-stack hourglass-104, HRNet-w32,
HRNetV2-w40, ShuffleNetV2 0.5x and 1-stack CenterNet and RRNet detectors,
which must also load strictly into the port's models (built on the meta
device, so the check costs no copy). Also: `reference_state_dict` maps a
port state_dict back to the layout that converts to it again;
`merge_pretrained` against JAX's followed by `from_flax`, with a shape
that differs and must be skipped; `load_torch_state_dict`'s unwrapping;
`visdrone_to_coco` on `data/demo` against JAX's JSON.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_layouts as layouts
from reference_layouts import RefDict
from rrnet_tpu.utils import convert as jconvert
from rrnet_torch.models.backbones.hourglass import HourglassNet
from rrnet_torch.models.backbones.hrnet import HRNetW32
from rrnet_torch.models.backbones.hrnetv2 import HRNetV2
from rrnet_torch.models.backbones.resnet import ResNet
from rrnet_torch.models.backbones.shufflenet import ShuffleNetV2
from rrnet_torch.models.centernet import CenterNet
from rrnet_torch.models.rrnet import RRNet
from rrnet_torch.utils import convert as tconvert
from rrnet_torch.utils.from_flax import (load_flax_variables,
                                         torch_state_dict_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (reference builder, converter name, converter kwargs, port model,
#        planted keys with whether the converters report them)
ARCHS = {
    "resnet50": (layouts.resnet, "convert_resnet_params", {},
                 lambda: ResNet((3, 4, 6, 3)),
                 {"layer1.9.conv1.weight": True, "fc.extra": False}),
    "hourglass_1stack": (lambda r: layouts.hourglass(r, num_stacks=1),
                         "convert_hourglass_params", {"num_stacks": 1},
                         lambda: HourglassNet(num_stacks=1),
                         {"hgs.0.up1.0.conv3.weight": True}),
    "hrnet_w32": (layouts.hrnet, "convert_hrnet_params", {}, HRNetW32,
                  {"final_layer.extra": False, "stage5.0.x": True}),
    "hrnetv2_w40": (lambda r: layouts.hrnet(r, 40, multi_scale=True),
                    "convert_hrnet_params", {}, HRNetV2, {}),
    "shufflenet_0.5x": (layouts.shufflenet, "convert_shufflenet_params", {},
                        lambda: ShuffleNetV2("0.5x"),
                        {"classifier.x": False, "features.99.w": True}),
    "centernet_1stack": (
        lambda r: layouts.detector(r, "centernet", num_stacks=1),
        "convert_detector_params", {"model": "centernet", "num_stacks": 1},
        lambda: CenterNet(num_stacks=1),
        {"backbone.extra.weight": False, "reg.extra.bias": True}),
    "rrnet_1stack": (
        lambda r: layouts.detector(r, "rrnet", num_stacks=1),
        "convert_detector_params", {"model": "rrnet", "num_stacks": 1},
        lambda: RRNet(num_stacks=1),
        {"backbone.hgs.0.extra": False, "head_detector.extra": True,
         "offset_reg.detect_layer.5.1.weight": True}),
}


def reference(name, small, seed=0):
    build, *_, planted = ARCHS[name]
    r = RefDict(seed, small=small)
    sd = build(r)
    for k in planted:
        sd[k] = np.ones((2, 2), np.float32)
    sd["extra.num_batches_tracked"] = np.asarray(3, np.int64)
    return sd


def both(name, sd):
    _, conv, kw, *_ = ARCHS[name]
    params, stats, jreport = getattr(jconvert, conv)(sd, **kw)
    want = torch_state_dict_from_flax({"params": params,
                                       "batch_stats": stats})
    got, report = getattr(tconvert, conv)(sd, **kw)
    return got, report, want, jreport


def assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_key_mapping_equals_jax(name):
    sd = reference(name, small=True)
    got, report, want, jreport = both(name, sd)
    assert_bit_equal(got, want)
    assert report == jreport
    planted = ARCHS[name][-1]
    assert sorted(k for k, shown in planted.items() if shown) == \
        report["unexpected"]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_real_shapes_equal_jax_and_load_strictly(name):
    sd = reference(name, small=False, seed=1)
    got, report, want, jreport = both(name, sd)
    assert_bit_equal(got, want)
    assert report == jreport
    del want
    with torch.device("meta"):
        model = ARCHS[name][3]()
    model.load_state_dict(got, strict=True, assign=True)


@pytest.mark.parametrize("name", ["hourglass_1stack", "shufflenet_0.5x",
                                  "rrnet_1stack", "hrnet_w32"])
def test_reference_state_dict_round_trip(name):
    """The table read backwards gives the reference layout (the planted
    keys and the heads left out aside), and that converts back to the
    same state_dict."""
    sd = reference(name, small=True)
    _, conv, kw, _, planted = ARCHS[name]
    got, _ = getattr(tconvert, conv)(sd, **kw)
    table = {"convert_hourglass_params": tconvert.hourglass_table,
             "convert_shufflenet_params": tconvert.shufflenet_table,
             "convert_detector_params": tconvert.detector_table,
             "convert_hrnet_params": tconvert.hrnet_table}[conv]
    back = tconvert.reference_state_dict(lambda t: table(t, **kw), got)
    kept = {k for k in sd if "num_batches_tracked" not in k
            and k not in planted
            and not k.startswith(("final_layer", "classifier"))}
    assert set(back) == kept
    for k in back:
        assert torch.equal(back[k], torch.from_numpy(sd[k])), k
    again, report = getattr(tconvert, conv)(back, **kw)
    assert report == {"unexpected": []}
    assert_bit_equal(again, got)


def numpy_variables(module, x, seed):
    """Numpy variables on the shapes of `module`'s init (traced by
    eval_shape, not run)."""
    shapes = jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x,
                                                  train=False), x)
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32) * 0.1, shapes)


@pytest.mark.parametrize("scoped", [True, False])
def test_merge_pretrained_matches_jax(scoped):
    """A converted resnet10 grafted into a RetinaNet's `backbone` scope
    (or into a bare ResNet, at the top), one entry's shape differing."""
    from rrnet_tpu.models.backbones.resnet import resnet10 as j_resnet10
    from rrnet_tpu.models.retinanet import RetinaNet as JRetinaNet
    from rrnet_torch.models.backbones.resnet import resnet10
    from rrnet_torch.models.retinanet import RetinaNet

    sd = layouts.resnet(RefDict(5), layers=(1, 1, 1, 1))
    sd["layer2.0.conv2.weight"] = sd["layer2.0.conv2.weight"][:, :, :2]
    params, stats, _ = jconvert.convert_resnet_params(sd, (1, 1, 1, 1))
    port_sd, _ = tconvert.convert_resnet_params(sd, (1, 1, 1, 1))
    x = jnp.zeros((1, 64, 64, 3))
    if scoped:
        jm, tm = JRetinaNet(backbone="resnet10"), RetinaNet(
            backbone="resnet10")
    else:
        jm, tm = j_resnet10(), resnet10()
    v = numpy_variables(jm, x, seed=2)
    tm = load_flax_variables(tm, v)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    want = torch_state_dict_from_flax(
        jconvert.merge_pretrained(v, params, stats, "backbone"))
    assert tconvert.merge_pretrained(tm, port_sd, "backbone") is tm
    assert_bit_equal({k: t.contiguous() for k, t in
                      tm.state_dict().items()}, want)
    pre = "backbone." if scoped else ""
    skipped = pre + "layer2_0.conv2.weight"
    assert torch.equal(tm.state_dict()[skipped], before[skipped])
    assert torch.equal(tm.state_dict()[pre + "conv1.weight"],
                       port_sd["conv1.weight"])


@pytest.mark.parametrize("wrap", ["model", "state_dict", "plain"])
def test_load_torch_state_dict_unwraps(tmp_path, wrap):
    sd = {"module.conv1.weight": torch.arange(6.0).reshape(2, 3, 1, 1),
          "bn1.running_var": torch.ones(2)}
    payload = {"plain": sd, "model": {"model": sd, "epoch": 3},
               "state_dict": {"state_dict": sd}}[wrap]
    path = str(tmp_path / "m.pth")
    torch.save(payload, path)
    got = tconvert.load_torch_state_dict(path)
    want = jconvert.load_torch_state_dict(path)
    assert list(got) == list(want) == ["conv1.weight", "bn1.running_var"]
    for k in want:
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("split", ["train", "val"])
def test_visdrone_to_coco_matches_jax(tmp_path, split):
    demo = os.path.join(REPO, "data", "demo")
    got = tconvert.visdrone_to_coco(demo, split, str(tmp_path / "t.json"))
    want = jconvert.visdrone_to_coco(demo, split, str(tmp_path / "j.json"))
    with open(got) as f, open(want) as g:
        a, b = json.load(f), json.load(g)
    assert a == b and len(a["annotations"]) > 0
    assert [c["id"] for c in a["categories"]] == list(range(12))
