"""body_issue_ms.eval: host ms a batch of the traced stretch's quiet pass
in the port's spans `rrnet.backbone` and `rrnet.attention`: issuing the
hourglass or HRNet body and the attention of every scale's forward."""

from rrbench import spans


def read(r):
    return spans.ms_a_batch(r, ("rrnet.backbone", "rrnet.attention"))
