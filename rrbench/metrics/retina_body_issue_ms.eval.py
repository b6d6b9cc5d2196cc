"""retina_body_issue_ms.eval: host ms a batch of the traced stretch's
quiet pass in the port's spans `retinanet.backbone`, `retinanet.fpn`
and `retinanet.heads`: issuing RetinaNet's ResNet, FPN and towers."""

from rrbench import spans


def read(r):
    return spans.ms_a_batch(r, ("retinanet.backbone", "retinanet.fpn",
                                "retinanet.heads"))
