"""Train-state checkpoints (port of `rrnet_tpu/utils/checkpoint.py`, which
uses orbax): the full state through `torch.save`, params, BN statistics,
both Adam moments, both counts and the step, so a run resumes where it
stopped. Step-indexed directories `ckp-{step}` under a log directory,
the oldest removed beyond `keep`. `save_params_only` / `load_params_only`
write and read a bare {name: tensor} mapping (an inference export, the
reference's state_dict).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Mapping, Optional

import torch

from rrnet_torch.train.state import TrainState

_FILE = "state.pt"


def _layout(state: TrainState):
    """The state's layout as plain lists, as the checkpoint stores it."""
    return {"params": [[k, list(s)] for k, s in state.layout.params],
            "stats": [[k, list(s)] for k, s in state.layout.stats]}


def save_checkpoint(log_dir: str, state: TrainState,
                    step: Optional[int] = None, keep: int = 5) -> str:
    """Write `state` to `log_dir/ckp-{step}` (step: the state's own by
    default) and keep the newest `keep` checkpoints. Returns the path."""
    step = int(state.step) if step is None else step
    path = os.path.abspath(os.path.join(log_dir, f"ckp-{step}"))
    os.makedirs(path, exist_ok=True)
    payload = {k: v.detach().cpu() for k, v in state.tensors().items()}
    payload["layout"] = _layout(state)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    _cleanup(log_dir, keep)
    return path


def restore_checkpoint(log_dir_or_path: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Fill `state` (a template from `Trainer.init_state`, same layout)
    from a checkpoint: `log_dir/ckp-{step}`, the newest under `log_dir`,
    or the `ckp-*` path itself. Returns the state."""
    path = log_dir_or_path
    if step is not None:
        path = os.path.join(log_dir_or_path, f"ckp-{step}")
    elif not os.path.basename(os.path.normpath(path)).startswith("ckp-"):
        steps = available_steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = os.path.join(path, f"ckp-{steps[-1]}")
    payload = torch.load(os.path.join(path, _FILE), map_location="cpu",
                         weights_only=True)
    if payload.pop("layout") != _layout(state):
        raise ValueError(f"checkpoint {path} was saved for another model")
    for name, t in state.tensors().items():
        src = payload[name]
        if src.shape != t.shape:
            raise ValueError(f"checkpoint {path}: {name} has shape "
                             f"{tuple(src.shape)}, want {tuple(t.shape)}")
        t.copy_(src)
    return state


def available_steps(log_dir: str) -> List[int]:
    if not os.path.isdir(log_dir):
        return []
    steps = []
    for d in os.listdir(log_dir):
        if d.startswith("ckp-"):
            try:
                steps.append(int(d.split("-")[1]))
            except ValueError:
                continue
    return sorted(steps)


def _cleanup(log_dir: str, keep: int) -> None:
    steps = available_steps(log_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(log_dir, f"ckp-{s}"), ignore_errors=True)


def save_params_only(path: str, params: Mapping[str, torch.Tensor]) -> str:
    """Write {name: tensor} (e.g. a model's state_dict, or
    `TrainState.state_dict()`) to the file `path`, replacing it whole.
    Returns the path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in params.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_params_only(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
