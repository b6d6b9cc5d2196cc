"""Shared fixtures of the benchmark's own tests (CPU; the card's tests
are marked `cuda` and decide inside a fixture whether a card is here)."""

import pytest
import torch

# the CPU tests' sizes: the tiny hourglass of the port's own tests (or
# HRNetV2, which is small), a few candidates, small frames; the port computes in float32 here so
# that a sound run reads next to nothing
TINY = {"model": {"backbone": "tiny_hourglass", "topk": 100,
                  "stage2_rois": 32},
        "weights": {"calibration_hw": [120, 200]}}
F32 = {"dtype": "float32"}


def tiny_cell(workload, seed=5, seconds=1.0, f32=True, **traffic):
    from rrbench import harness
    over = {k: dict(v) for k, v in TINY.items()}
    over["val"] = {"scales": [1.0, 1.3]}
    if workload.startswith("hrnet"):
        over["model"]["backbone"] = "hrnetv2"
    traffic = {"frame_hw": [120, 200], "pool": 4, "batch": 2,
               "check_batch_max": 1, **traffic}
    cell = harness.Cell(workload, seed, seconds, False, "cpu",
                        overrides=over, traffic=traffic, check_params=False)
    if f32:
        cell.config.update(F32)
    return cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
