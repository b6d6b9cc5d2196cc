"""issue_ms.eval: host ms a batch in `Evaluator.dispatch_batch` (every
scale's forward queued), over the window's calls."""


def read(r):
    calls = r["spans"].get("issue")
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
