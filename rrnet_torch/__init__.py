"""rrnet_torch — RRNet on PyTorch and CUDA for one NVIDIA H100.

A second package beside `rrnet_tpu`, the JAX/TPU implementation, which
stays unchanged as the frozen reference every module here is tested
against (`tests/test_torch_*.py`: same numpy inputs, same weights carried
across by `utils.from_flax`).

Ground rules:

  * Imports. This package imports `torch` and numpy only. It never
    imports `jax`, `flax` or anything of `rrnet_tpu`, not even that
    package's pure-numpy modules; what it needs from them is copied
    here (`config.py`, `data/`, `evallib/{metrics,writer}.py`,
    `utils/timer.py`). JPEG files go through PIL (`data/jpeg.py`,
    imported inside its functions); OpenCV is not used. `tests/test_torch_rrnet.py`
    enforces this.
  * Layout. Modules compute in NCHW (cuDNN's layout). Public results keep
    the JAX package's NHWC shapes: `RRNetOutputs.hms/whs/offsets`,
    `ops.heatmap.Detections` and the (B, R, 3, 3, C) ROI-align output.
  * Device. Entry points (`build_model`, `build_backbone`,
    `evallib.infer.Evaluator`, `serving.Predictor`, `train.Trainer`)
    default to `device="cuda"` and raise when no
    card is present; they never carry on on the CPU unless the caller
    asks for it (the tests pass `device="cpu"`).
  * Kernels. Every Pallas kernel of the JAX package on a ported path is a
    hand-written CUDA kernel here (`csrc/`, built at first use into
    `build/rrnet_torch/`). Its wrapper runs the plain PyTorch version for
    a CPU tensor and launches the kernel or raises for a CUDA tensor:
    there is no fallback.
  * Dtypes. Compute dtype comes from `cfg.model.dtype` (bf16 for the
    preset); parameters stay f32; decode, NMS and ROI-align run in f32.

Ported so far: the serving path of the flagship `rrnet` preset
(hourglass-104, 2 stacks) at deployment settings (one scale, no flip),
with stage-1 soft-NMS as the CUDA kernel `csrc/soft_nms.cu`; the
trident backbones (`models.build_backbone("trires50deform")` and kin),
served and trained in f32, with the modulated deformable conv's forward
and backward as the CUDA kernels `csrc/dcn_fwd.cu` and `csrc/dcn_bwd.cu`
(`ops.deform_conv`; the plain version is `ops.dcn`); the flagship RRNet's
train step on one card (`train.Trainer`: targets, losses, criterions,
schedule, skip-aware Adam, `utils.checkpoint`); and the class-parallel
soft-NMS (`ops.soft_nms.soft_nms_auto(..., class_parallel=True)`) as the
CUDA kernel `csrc/soft_nms_classes.cu`; the data pipeline (`data.visdrone`,
`data.transforms`, `data.synth`, `data.loader`), the train CLI
(`python -m rrnet_torch.scripts.train`), and the split evaluator
(`evallib.infer.Evaluator.evaluate_split`, `evallib.metrics`) with the
synthetic train -> eval -> AP gate (`python -m
rrnet_torch.scripts.synth_gate`); the presets' eval protocol, CenterNet
and RetinaNet; the fourth preset, `rrnet_hrnetv2_attention` (HRNetV2-w40
with the windowed self-attention of `models.modules`); every backbone
of the JAX registry (`models.backbones.get_backbone`); and data-parallel
training with SyncBN over `torch.distributed` (`parallel`,
`train.Trainer(group=...)`, the train CLI's `--multihost`, the eval
CLI's `--data-parallel`).
"""
