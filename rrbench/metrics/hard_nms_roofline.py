"""hard_nms_roofline: the least time of one `csrc/hard_nms.cu` launch,
counted on the candidates the reference derives for the traced batch's
frames (`counts.hard_nms_work`, each scale's launch), over the kernel's
mean device time a launch in the trace."""

from rrbench import counts


def read(r):
    h = r.get("hard_nms")
    if not h or not h["device_s"]:
        return None
    mean_ms = 1e3 * sum(h["device_s"]) / len(h["device_s"])
    return counts.share(100.0 * h["bound_ms"] / mean_ms, "hard_nms_roofline")
