"""tail_issue_ms.eval: host ms a batch of the traced stretch's quiet pass
in the port's spans `rrnet.heads`, `.decode`, `.nms`, `.roi_align` and
`.stage2`: issuing the tail that both backbones share."""

from rrbench import spans


def read(r):
    return spans.ms_a_batch(r, ("rrnet.heads", "rrnet.decode", "rrnet.nms",
                                "rrnet.roi_align", "rrnet.stage2"))
