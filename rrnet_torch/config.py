"""Configuration tree: a copy of `rrnet_tpu/config.py`'s dataclasses.

The field names, defaults and override semantics are the JAX package's,
so one override list configures both implementations. `MeshConfig`
describes the data-parallel layout: in the JAX package a
`jax.sharding.Mesh`, here a `torch.distributed` process group
(`parallel.create_group`), one rank a device.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence, Tuple


@dataclass
class TrainConfig:
    batch_size: int = 4          # per device
    num_workers: int = 4
    lr: float = 2.5e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_milestones: Tuple[int, ...] = (60000, 80000)
    lr_gamma: float = 0.1
    warmup_steps: int = 0
    warmup_factor: float = 1.0 / 3.0
    iter_num: int = 100000
    crop_size: Tuple[int, int] = (512, 512)   # (h, w)
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    scale_factor: int = 4        # output stride of the stride-4 feature map
    with_road: bool = True
    multi_scales: Tuple[float, ...] = (1.0, 1.15, 1.25, 1.35, 1.5)
    hflip_prob: float = 0.5
    fill_duck: bool = True
    fill_duck_classes: Tuple[int, ...] = (1, 2, 3, 7, 8, 10)
    fill_duck_factor: float = 0.00005
    max_objects: int = 320
    wh_weight: float = 0.1
    stage2_warmup_steps: int = 2000
    print_interval: int = 20
    checkpoint_interval: int = 5000
    pretrained: bool = True
    transport: str = "rgb"


@dataclass
class ValConfig:
    batch_size: int = 1
    num_workers: int = 4
    model_path: str = ""
    auto_test: bool = True
    scales: Tuple[float, ...] = (1.0, 1.1, 1.2, 1.3, 1.4, 1.5)
    flip_tta: bool = False
    score_threshold: float = 0.01
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    result_dir: str = "./results"
    max_det: int = 500
    # 'yuv420' ships Y + 2x2-subsampled CbCr planes (1.5 B/px) and
    # rebuilds RGB on the device; 'rgb' ships raw uint8 RGB (3 B/px).
    transport: str = "yuv420"


@dataclass
class SoftNMSConfig:
    method: str = "gaussian"     # 'gaussian' | 'linear' | 'hard'
    sigma: float = 0.5
    iou_threshold: float = 0.7   # Nt
    score_threshold: float = 0.1


@dataclass
class ModelConfig:
    name: str = "rrnet"
    backbone: str = "hourglass"
    num_stacks: int = 2
    head_channels: int = 256
    wh_kernel: int = 17          # asymmetric 17x1 / 1x17 wh-head kernels
    topk: int = 1500
    nms_type_for_stage1: str = "nms"     # 'nms' | 'soft_nms'
    nms_per_class_for_stage1: bool = True
    stage1_nms_iou: float = 0.7
    stage2_rois: int = 512
    soft_nms: SoftNMSConfig = field(default_factory=SoftNMSConfig)
    with_self_attention: bool = False
    anchor_levels: Tuple[int, ...] = (3, 4, 5)
    anchor_sizes: Tuple[int, ...] = (16, 64, 128)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_scales: Tuple[float, ...] = (1.0, 1.2599210498948732, 1.5874010519681994)
    fpn_channels: int = 256
    retina_pos_iou: float = 0.5
    retina_neg_iou: float = 0.4
    retina_alpha: float = 0.75
    retina_gamma: float = 2.0
    dtype: str = "bfloat16"      # compute dtype: 'float32' | 'bfloat16'
    param_dtype: str = "float32"
    sync_bn: bool = True


@dataclass
class MeshConfig:
    """The data-parallel layout (the JAX package's mesh description). Axis
    sizes of -1 mean "every rank"; no model uses the model axis, so
    `parallel.create_group` refuses `model_parallel > 1`."""
    data_axis: str = "data"
    data_parallel: int = -1      # -1 => the process group's world size
    model_axis: str = "model"
    model_parallel: int = 1


@dataclass
class Config:
    seed: int = 219
    dataset: str = "drones_det"
    data_root: str = "./data/DronesDET"
    log_prefix: str = "TwoStageNet"
    log_dir: str = "./log"
    use_tensorboard: bool = True
    num_classes: int = 10

    train: TrainConfig = field(default_factory=TrainConfig)
    val: ValConfig = field(default_factory=ValConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def rrnet_config(**overrides: Any) -> Config:
    """The flagship preset (reference configs/rrnet_config.py)."""
    cfg = Config(
        log_prefix="TwoStageNet",
        model=ModelConfig(name="rrnet", backbone="hourglass", num_stacks=2,
                          sync_bn=True),
    )
    for k, v in overrides.items():
        cfg = set_by_path(cfg, k, v)
    return cfg


def centernet_config(**overrides: Any) -> Config:
    """The CenterNet preset (reference configs/centernet_config.py): no
    SyncBN, flip TTA at eval."""
    cfg = Config(
        log_prefix="CenterNet",
        model=ModelConfig(name="centernet", backbone="hourglass",
                          num_stacks=2, sync_bn=False),
        val=ValConfig(flip_tta=True),
    )
    for k, v in overrides.items():
        cfg = set_by_path(cfg, k, v)
    return cfg


def retinanet_config(**overrides: Any) -> Config:
    """The RetinaNet preset (reference configs/retinanet_config.py, its
    live parts): ResNet-50 + FPN, lr 1e-4, no road map and no FillDuck in
    the train transforms, one eval scale, no SyncBN, and
    `val.auto_test=False`, which the Evaluator does not read for this
    family: its decode already NMS'd on the device, so no host merge."""
    cfg = Config(
        log_prefix="RetinaNet",
        train=TrainConfig(lr=1e-4, with_road=False, fill_duck=False),
        model=ModelConfig(name="retinanet", backbone="resnet50",
                          num_stacks=1, sync_bn=False),
        val=ValConfig(scales=(1.0,), auto_test=False),
    )
    for k, v in overrides.items():
        cfg = set_by_path(cfg, k, v)
    return cfg


def rrnet_hrnetv2_attention_config(**overrides: Any) -> Config:
    """RRNet on HRNetV2-w40 with the windowed self-attention added to
    each stack's feature (the JAX package's `rrnet_hrnetv2_attention`
    preset; the reference defined the attention module but never wired
    it). Stack 0 reads HRNetV2's 40-channel map, stack 1 its 80-channel
    map, stage 2 its 320-channel map."""
    cfg = Config(
        log_prefix="RRNetHRNetV2Attn",
        model=ModelConfig(name="rrnet", backbone="hrnetv2", num_stacks=2,
                          sync_bn=True, with_self_attention=True),
    )
    for k, v in overrides.items():
        cfg = set_by_path(cfg, k, v)
    return cfg


PRESETS = {"rrnet": rrnet_config, "centernet": centernet_config,
           "retinanet": retinanet_config,
           "rrnet_hrnetv2_attention": rrnet_hrnetv2_attention_config}


def set_by_path(cfg: Any, path: str, value: Any) -> Any:
    """Return a copy of `cfg` with the dotted-path field replaced, e.g.
    set_by_path(cfg, 'model.topk', 64)."""
    head, _, rest = path.partition(".")
    if not hasattr(cfg, head):
        raise AttributeError(f"config has no field {head!r} (path {path!r})")
    if rest:
        sub = set_by_path(getattr(cfg, head), rest, value)
        return dataclasses.replace(cfg, **{head: sub})
    cur = getattr(cfg, head)
    if cur is not None and not isinstance(cur, (bool, str)) and isinstance(cur, (int, float)):
        value = type(cur)(value) if not isinstance(value, (tuple, list)) else value
    return dataclasses.replace(cfg, **{head: value})


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply 'a.b.c=value' override strings (values parsed as Python
    literals when possible)."""
    for ov in overrides:
        path, _, raw = ov.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        cfg = set_by_path(cfg, path.strip(), value)
    return cfg
