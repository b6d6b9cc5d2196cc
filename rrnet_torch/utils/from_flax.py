"""Carries the JAX package's weights across to the port.

Input: the `{"params": ..., "batch_stats": ...}` variables of a flax
model as nested dicts of numpy arrays (`jax.tree.map(np.asarray, v)` on
the JAX side; nothing here needs JAX). Output: a `state_dict` for the
port's module of the same name, whose module names follow the flax
scopes. The conversions:

  * conv kernels HWIO -> OIHW: the plain convs, the 7x7 stem as it is
    stored (not its space-to-depth form), the heads' `_ConvParam`
    kernels ((1,1,C,p) out convs, (k,1,C,p) / (1,k,C,p) wh convs), and
    the trident's shared `weight` (`SharedConv`, one kernel for three
    branches);
  * Dense kernels (in, out) -> (out, in);
  * BatchNorm `scale`/`bias` and `batch_stats` `mean`/`var` ->
    `weight`/`bias`/`running_mean`/`running_var` (the flax `BatchNorm_0`
    scope is dropped).

A leaf no rule maps raises; `load_flax_variables` also raises on a
parameter the model has and the tree lacks, or the other way round, and
on any shape that differs.

`quant_scales_from_flax` carries a JAX int8 calibration (`{scope path:
absmax}`) across by the same naming rule (a conv's scope path is its
module name, "/" becoming "."), and `quant_scales_to_flax` back.

`load_flax_train_state` carries a whole JAX `TrainState` across into the
port's `train.TrainState`: params and batch_stats by the rules above,
Adam's `mu` and `nu` by the params' key map, Adam's count, the schedule's
count and the step. Its input is the JAX package's checkpoint payload
(`rrnet_tpu/utils/checkpoint.py`) as numpy: `{"step", "params",
"batch_stats", "opt_state"}` with `opt_state` the optax chain's
`(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))`, as
named tuples or dicts.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_BN = "BatchNorm_0"


def _leaves(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _convert(collection: str, path: Tuple[str, ...], leaf):
    name = path[-1]
    scope = path[:-1]
    if _BN in scope:
        if scope[-1] != _BN:
            raise ValueError(f"unexpected leaf under {_BN}: {path}")
        torch_name = {("params", "scale"): "weight",
                      ("params", "bias"): "bias",
                      ("batch_stats", "mean"): "running_mean",
                      ("batch_stats", "var"): "running_var"}.get(
                          (collection, name))
        if torch_name is None:
            raise ValueError(f"unmapped BatchNorm leaf {collection}/"
                             f"{'/'.join(path)}")
        return ".".join(scope[:-1] + (torch_name,)), np.asarray(leaf)
    if collection != "params":
        raise ValueError(f"unmapped leaf {collection}/{'/'.join(path)}")
    if name == "bias" and np.ndim(leaf) == 1:
        return ".".join(scope + ("bias",)), np.asarray(leaf)
    if name in ("kernel", "weight") and np.ndim(leaf) == 4:   # HWIO -> OIHW
        return ".".join(scope + ("weight",)), np.transpose(leaf, (3, 2, 0, 1))
    if name == "kernel" and np.ndim(leaf) == 2:        # Dense (in, out)
        return ".".join(scope + ("weight",)), np.transpose(leaf)
    raise ValueError(f"unmapped leaf params/{'/'.join(path)} with shape "
                     f"{np.shape(leaf)}")


def numpy_state_from_flax(variables) -> Dict[str, np.ndarray]:
    """{torch state_dict key: numpy array (possibly a transposed view)}
    for every leaf of `variables`; raises on an unmapped leaf."""
    out: Dict[str, np.ndarray] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unmapped collection {collection!r}")
        for path, leaf in _leaves(tree):
            key, arr = _convert(collection, path, leaf)
            if key in out:
                raise ValueError(f"two leaves map to {key}")
            out[key] = arr
    return out


def torch_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """A state_dict (f32 CPU tensors) for the port's model from the JAX
    package's variables."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in numpy_state_from_flax(variables).items()}


def check_state_shapes(expected: Mapping[str, Tuple[int, ...]],
                       got: Mapping[str, Tuple[int, ...]]) -> None:
    """Raise unless `got` has exactly the keys of `expected`, with equal
    shapes."""
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    if missing or extra:
        raise ValueError(f"state mismatch: missing {missing[:10]} "
                         f"({len(missing)}), extra {extra[:10]} ({len(extra)})")
    bad = [(k, tuple(expected[k]), tuple(got[k])) for k in expected
           if tuple(expected[k]) != tuple(got[k])]
    if bad:
        raise ValueError(f"shape mismatch (key, model, converted): {bad[:10]}")


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Load the JAX package's variables into the port's `model`, checking
    that every parameter and buffer is covered with its shape."""
    sd = torch_state_dict_from_flax(variables)
    check_state_shapes({k: v.shape for k, v in model.state_dict().items()},
                       {k: v.shape for k, v in sd.items()})
    model.load_state_dict(sd, strict=True)
    return model


def _fields(node, names: Tuple[str, ...], what: str) -> Dict:
    if hasattr(node, "_asdict"):
        d = dict(node._asdict())
    elif isinstance(node, Mapping):
        d = dict(node)
    else:
        raise ValueError(f"unmapped {what}: {type(node).__name__}")
    if set(d) != set(names):
        raise ValueError(f"unmapped {what} leaves: have {sorted(d)}, "
                         f"want {sorted(names)}")
    return d


def load_flax_train_state(state, tree):
    """Fill the port's TrainState `state` (its layout fixes the expected
    names and shapes) from the JAX package's train state `tree` (see the
    module docstring); raises on a leaf left unmapped, a missing or extra
    key, or a shape that differs. Returns the state."""
    top = _fields(tree, ("step", "params", "batch_stats", "opt_state"),
                  "train state")
    opt = top["opt_state"]
    if not isinstance(opt, (tuple, list)) or len(opt) != 2:
        raise ValueError("unmapped optimizer state: want (adam, schedule)")
    adam = _fields(opt[0], ("count", "mu", "nu"), "Adam state")
    sched = _fields(opt[1], ("count",), "schedule state")

    sd = numpy_state_from_flax({"params": top["params"],
                                "batch_stats": top["batch_stats"]})
    moments = [numpy_state_from_flax({"params": adam[k]})
               for k in ("mu", "nu")]
    params = dict(state.layout.params)
    check_state_shapes({**params, **dict(state.layout.stats)},
                       {k: a.shape for k, a in sd.items()})
    for m in moments:
        check_state_shapes(params, {k: a.shape for k, a in m.items()})

    def put(views, arrays):
        for k, v in views.items():
            v.copy_(torch.from_numpy(np.array(arrays[k], dtype=np.float32)))

    put(state.state_dict(), sd)
    for views, m in zip(state.moments(), moments):
        put(views, m)
    state.step.fill_(int(top["step"]))
    state.count.fill_(int(adam["count"]))
    state.sched_count.fill_(int(sched["count"]))
    return state


def quant_scales_from_flax(scales: Mapping[str, float]) -> Dict[str, float]:
    """The JAX package's calibration scales ({"a/b/conv": absmax}, keys
    the convs' flax scope paths) keyed by the port's module names."""
    out = {}
    for key, v in scales.items():
        if _BN in key.split("/"):
            raise ValueError(f"a calibration scale under {_BN}: {key}")
        out[key.replace("/", ".")] = float(v)
    return out


def quant_scales_to_flax(scales: Mapping[str, float]) -> Dict[str, float]:
    """The port's calibration scales keyed by the JAX scope paths."""
    return {k.replace(".", "/"): float(v) for k, v in scales.items()}
