"""mfu.eval: the reference's FLOPs of every scale's forward times the
frames finished, over the window, over the card's bf16 dense peak."""

from rrbench import counts


def read(r):
    w = r["work"]
    if not w.get("flops_per_image"):
        return None
    rate = w["images"] * w["flops_per_image"] / r["window_s"]
    return counts.share(100.0 * rate / counts.PEAK_BF16_FLOPS, "mfu.eval")
