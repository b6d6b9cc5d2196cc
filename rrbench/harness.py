"""What every run shares: the manifest, the cell's files found by name,
the port's configuration and the reference built from them, the metric
readers, and the result line.

A cell is one entry of `BENCHMARK.json`'s `workloads`. Its files:

  * `rrbench/configs/<config>.json` (the path the manifest gives): the
    preset, every width and setting as run, `reduced`, `assumed`, the
    parameter count;
  * `rrbench/traffic/<traffic>.json`: the traffic's parameters, and its
    `kind`, which names the general driver `rrbench/drivers/<kind>.py`;
  * `rrbench/checks/<workload>.json`: each number the run compares with
    the reference, its limit, and the readings the limit was set from;
  * `rrbench/metrics/<metric>.py`: one reader a per-layer metric, with
    `read(record)` returning the value or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rrnet_tpu")


class UnknownName(KeyError):
    """A workload, configuration, traffic mix or metric the files do not
    hold."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise UnknownName(f"no {what} named {name!r}")


def _file(directory: str, name: str, suffix: str) -> Path:
    path = BENCH / directory / f"{name}{suffix}"
    if not path.is_file():
        raise UnknownName(f"no {directory} file {path.name!r}")
    return path


def reader(metric: str):
    """The `read` function of `rrbench/metrics/<metric>.py`."""
    path = _file("metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(
        f"rrbench.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """One workload of the manifest with its files, run on `device` with
    `seed` for `seconds`. `overrides` updates the configuration file's
    groups (`{"model": {...}, "train": {...}}`) and `traffic` the
    traffic's entries (the CPU tests' tiny sizes); `check_params` holds
    the built model to the file's parameter count."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device, man: Optional[dict] = None,
                 overrides: Optional[dict] = None,
                 traffic: Optional[dict] = None,
                 check_params: bool = True):
        man = manifest() if man is None else man
        self.entry = _named(man["workloads"], workload, "workload")
        self.name = workload
        self.seed = int(seed) % 2 ** 63
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        cfg_entry = _named(man["configs"], self.entry["config"],
                           "configuration")
        self.config = load_json(ROOT / cfg_entry["file"])
        for group, entries in (overrides or {}).items():
            self.config[group] = {**self.config[group], **entries}
        self.traffic = {**load_json(_file("traffic", self.entry["traffic"],
                                          ".json")), **(traffic or {})}
        self.limits = load_json(_file("checks", workload, ".json"))
        self.check_params = check_params
        self.e2e = [m for m in man["end_to_end"]
                    if workload in m.get("workloads", [workload])]
        names = {m["name"] for m in self.e2e}
        self.per_layer = [m for m in man["per_layer"]
                          if workload in m.get("workloads", [workload])
                          and m["moves"] in names]

    def driver(self):
        kind = self.traffic["kind"]
        try:
            return importlib.import_module(f"rrbench.drivers.{kind}")
        except ModuleNotFoundError as e:
            raise UnknownName(f"no driver for traffic kind {kind!r}") from e

    # -- the port's configuration and the reference --------------------
    def port_config(self):
        """The port's `Config`: the preset with every entry of the
        configuration file and the traffic's `config` applied."""
        from rrnet_torch.config import PRESETS, set_by_path
        c = self.config
        cfg = PRESETS[c["preset"]]()
        sets = {"num_classes": c["num_classes"], "model.dtype": c["dtype"],
                "model.param_dtype": c["param_dtype"]}
        for group in ("model", "val", "train"):
            for k, v in c.get(group, {}).items():
                sets[f"{group}.{k}"] = v
        sets.update(self.traffic.get("config", {}))
        for path, v in sets.items():
            cfg = set_by_path(cfg, path, tuple(v) if isinstance(v, list)
                              else v)
        return cfg

    def arch(self) -> dict:
        m = self.config["model"]
        if m["nms_type_for_stage1"] != "nms":
            raise ValueError("the reference runs hard stage-1 NMS only")
        return {"num_classes": self.config["num_classes"],
                "num_stacks": m["num_stacks"], "backbone": m["backbone"],
                "wh_kernel": m["wh_kernel"], "topk": m["topk"],
                "stage2_rois": m["stage2_rois"],
                "nms_iou": m["stage1_nms_iou"],
                "nms_per_class": m["nms_per_class_for_stage1"],
                "with_attention": m["with_self_attention"]}

    def reference(self, weights):
        """The reference model on the device with `weights` (strict)."""
        import torch
        from rrbench.reference.model import build_rrnet
        with torch.device(self.device):
            ref = build_rrnet(self.arch())
        ref.load_state_dict(weights, strict=True)
        return ref.eval()

    def weights_for(self, module):
        """The cell's seeded, calibrated weights for `module`'s state dict
        (`rrbench.weights`), on the host, after checking its parameter
        count against the configuration file."""
        import torch
        from rrbench.frames import frames
        from rrbench.reference.pipeline import normalized
        from rrbench.weights import calibrate, make_weights, shapes_of
        n = sum(p.numel() for p in module.parameters())
        if self.check_params and n != self.config["param_count"]:
            raise ValueError(f"the port's {self.config['name']} has {n} "
                             f"parameters, the configuration file "
                             f"{self.config['param_count']}")
        w = self.config["weights"]
        ref = self.reference(make_weights(
            shapes_of(module), self.seed, self.device,
            tuple(w["branch_end_scale"])))
        val = self.config["val"]
        x = torch.cat([normalized(f, val["mean"], val["std"], self.device,
                                  val["transport"])[0]
                       for f in frames(self.seed, w["calibration_frames"],
                                       tuple(w["calibration_hw"]))])
        calibrate(ref, x, w)
        out = {k: v.detach().to("cpu", copy=True)
               for k, v in ref.state_dict().items()}
        del ref, x
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return out


def card() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"
    return out[0] if out else "nvidia-smi printed nothing"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    tops = {m.partition(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Dict:
    """Each compared number beside its limit; a number that is not
    finite, or that the limits do not name, fails."""
    out = {}
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit", -math.inf)
        out[name] = {"value": value, "limit": lim,
                     "ok": math.isfinite(value) and value <= lim}
    return out


def metrics_of(cell: Cell, rec: dict) -> Dict[str, dict]:
    """The run's metrics: the cell's end-to-end metrics, or with a trace
    its per-layer metrics that a reader finds something for."""
    out = {}
    if not cell.trace:
        for m in cell.e2e:
            if m["name"] == "setup_s":
                continue
            out[m["name"]] = {"value": rec["e2e"][m["name"]],
                              "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
