"""stage_ms.eval: host ms an image in `Evaluator.stage` (pad, I420 pack
and pinned upload, on the upload thread), over the window's calls."""


def read(r):
    calls = r["spans"].get("stage")
    if not calls:
        return None
    return 1e3 * sum(t for t, _ in calls) / sum(n for _, n in calls)
