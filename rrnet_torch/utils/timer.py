"""Wall-clock / ETA stamps (port of `rrnet_tpu/utils/timer.py`; reference
utils/vis/timer.py:4-36)."""

from __future__ import annotations

import time


def _hms(seconds: float) -> str:
    seconds = max(int(seconds), 0)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


class Timer:
    def __init__(self, total_steps: int = 0):
        self.total_steps = total_steps
        self.start_time = time.time()

    def start(self, total_steps: int):
        self.total_steps = total_steps
        self.start_time = time.time()

    def stamp(self, step: int) -> str:
        """'[elapsed < remaining]' like the reference (timer.py:18-29)."""
        elapsed = time.time() - self.start_time
        rate = elapsed / max(step, 1)
        remaining = rate * max(self.total_steps - step, 0)
        return f"[{_hms(elapsed)} < {_hms(remaining)}]"
