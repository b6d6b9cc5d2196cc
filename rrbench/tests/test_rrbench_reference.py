"""The frozen reference agrees with the port's plain path at tiny sizes
on the CPU, both computing in float32."""

import numpy as np
import pytest
import torch

from rrbench.reference import pipeline

from conftest import tiny_cell


@pytest.mark.parametrize("workload,backbone,attention", [
    ("rrnet-eval6", "tiny_hourglass", False),
    ("hrnet_attn-eval6", "hrnetv2", True)])
def test_forward_agrees_with_the_port(workload, backbone, attention):
    from rrnet_torch.models import build_model
    cell = tiny_cell(workload)
    cell.config["model"].update(backbone=backbone,
                                with_self_attention=attention)
    cfg = cell.port_config()
    port = build_model(cfg, device="cpu")
    w = cell.weights_for(port)
    port.load_state_dict(w)
    ref = cell.reference(w)
    x = torch.randn(2, 3, 128, 256, generator=torch.Generator().manual_seed(0))
    vhw = torch.tensor([[120, 200], [128, 256]], dtype=torch.int32)
    with torch.no_grad():
        a, b = port(x, valid_hw=vhw), ref(x, valid_hw=vhw)
    for s in range(2):
        for pa, pb in ((a.hms, b.hms), (a.whs, b.whs),
                       (a.offsets, b.offsets)):
            torch.testing.assert_close(pa[s], pb[s], rtol=1e-4, atol=1e-4)
    assert torch.equal(a.roi_classes, b.roi_classes)
    assert torch.equal(a.roi_valid, b.roi_valid)
    torch.testing.assert_close(a.rois, b.rois, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(a.stage2_reg, b.stage2_reg, rtol=1e-3,
                               atol=1e-4)


def test_detect_agrees_with_the_evaluator():
    from rrnet_torch.evallib.infer import Evaluator
    from rrnet_torch.models import build_model
    from rrbench.frames import frames
    cell = tiny_cell("rrnet-eval6")
    cfg = cell.port_config()
    port = build_model(cfg, device="cpu")
    w = cell.weights_for(port)
    port.load_state_dict(w)
    ev = Evaluator(cfg, port, device="cpu")
    imgs = frames(3, 2, (120, 200))
    got = ev.predict_batch(imgs)
    ref = cell.reference(w)
    for im, rows in zip(imgs, got):
        _, bucket, fwds = pipeline.forwards(ref, im, cfg.val.scales,
                                            cfg.val.mean, cfg.val.std)
        want = pipeline.sort_rows([pipeline.rows_of(f, 0, bucket)
                                   for f in fwds])
        assert rows.shape == want.shape
        np.testing.assert_allclose(rows, want, rtol=1e-4, atol=1e-3)

