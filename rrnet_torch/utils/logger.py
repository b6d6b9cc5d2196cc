"""Training logger (port of `rrnet_tpu/utils/logger.py`; reference
utils/vis/logger.py:9-92).

Process-0-gated logging: scalars (and optional image grids) to
TensorBoard, every line mirrored to `{log_dir}/{prefix}/log.txt` and
stdout with elapsed/ETA stamps. TensorBoard is optional: where
`torch.utils.tensorboard` does not import, the logger writes text only,
and training never depends on it. `start_trace`/`stop_trace` record a
`torch.profiler` trace (host and, on a card, device activity) and the
port's spans under the log directory (`utils.tracing.profiled`).
"""

from __future__ import annotations

import os
from typing import Dict

from rrnet_torch.utils import tracing
from rrnet_torch.utils.timer import Timer


def _make_tb_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class Logger:
    def __init__(self, cfg, main_process: bool = True):
        self.cfg = cfg
        self.main_process = main_process
        self.log_dir = os.path.join(cfg.log_dir, cfg.log_prefix)
        self.timer = Timer()
        self._tb = None
        self._prof = None
        if main_process:
            os.makedirs(self.log_dir, exist_ok=True)
            if cfg.use_tensorboard:
                self._tb = _make_tb_writer(self.log_dir)
            self._txt = open(os.path.join(self.log_dir, "log.txt"), "a")
        else:
            self._txt = None

    def init_timer(self, total_steps: int):
        self.timer.start(total_steps)

    # ------------------------------------------------------------------
    def log(self, data: Dict, step: int):
        """data: {'scalar': {tag: value}, 'imgs': {tag: [HWC arrays]}}."""
        if not self.main_process:
            return
        scalars = data.get("scalar", {})
        stamp = self.timer.stamp(step)
        line = f"{stamp} step {step}: " + " ".join(
            f"{k}={float(v):.5f}" for k, v in scalars.items())
        print(line, flush=True)
        if self._txt is not None:
            self._txt.write(line + "\n")
            self._txt.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
            for tag, imgs in data.get("imgs", {}).items():
                for i, img in enumerate(imgs):
                    self._tb.add_image(f"{tag}/{i}", img, step,
                                       dataformats="HWC")

    # ------------------------------------------------------------------
    def start_trace(self):
        """Start a torch.profiler trace (CPU, and CUDA where a card is
        present); `stop_trace` writes it under `{log_dir}/profile/`."""
        self._prof = tracing.profiled(
            os.path.join(self.log_dir, "profile")).start()

    def stop_trace(self) -> str:
        """Stop the trace and write it as a Chrome trace (`trace.json`,
        beside the spans in `spans.jsonl`); returns its path."""
        prof, self._prof = self._prof, None
        return prof.stop()

    def close(self):
        if self._txt is not None:
            self._txt.close()
        if self._tb is not None:
            self._tb.close()
