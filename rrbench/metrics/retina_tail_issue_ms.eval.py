"""retina_tail_issue_ms.eval: host ms a batch of the traced stretch's
quiet pass in the port's spans `retinanet.decode` and `retinanet.nms`:
issuing RetinaNet's decode (top-K anchors, deltas) and its hard NMS."""

from rrbench import spans


def read(r):
    return spans.ms_a_batch(r, ("retinanet.decode", "retinanet.nms"))
