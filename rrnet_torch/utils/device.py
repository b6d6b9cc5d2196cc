"""Device policy of the entry points: the card unless the caller asks
for the CPU, and never a silent move to the CPU."""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """torch.device for `device`; raises when a CUDA device is asked for
    and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def card_line() -> Optional[str]:
    """nvidia-smi's name and power limit of the first card ("NVIDIA H100
    80GB HBM3, 700.00 W"), or None where nvidia-smi does not answer."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def device_record(device: torch.device) -> dict:
    """Where a harness ran: the device type, the card and torch."""
    return {"type": device.type,
            "card": card_line() if device.type == "cuda" else None,
            "torch": torch.__version__}
