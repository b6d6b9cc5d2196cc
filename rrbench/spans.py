"""The port's own spans (`rrnet_torch.utils.tracing`) in a traced run,
set against the device trace of the same stretch (`rrbench/trace.py`).

The traced stretch runs `evaluate_split` twice under torch.profiler: the
quiet pass (CUDA activity alone), then the labelled pass. A profiler
session turns the port's spans on, so both passes leave records in the
port's store. The readers take the batches whose `eval.dispatch` began
inside the quiet pass (from its first device operation to the end of its
last) and every record of those batches. A span's start and end are
`time.time_ns()`, the clock of the trace's events. Without a trace,
without the port's tracing module (a program older than it) or without
such a batch, each function here returns None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from rrbench import trace


def _store() -> Optional[List[dict]]:
    try:
        from rrnet_torch.utils import tracing
    except ImportError:
        return None
    return tracing.records()


def _quiet(r):
    """(every record, the quiet pass's batch ids, their dispatching
    threads), or None."""
    tr = r.get("trace")
    recs = _store() if tr is not None else None
    if not recs:
        return None
    dev = tr.quiet.device
    lo, hi = dev[0][1], max(e for _, _, e in dev)
    disp = [x for x in recs if x["name"] == "eval.dispatch"
            and x["batch"] is not None and lo <= 1e-9 * x["start_ns"] <= hi]
    if not disp:
        return None
    return (recs, {x["batch"] for x in disp},
            {x["thread"] for x in disp})


def ms_a_batch(r, names: Iterable[str], less: Iterable[str] = ()
               ) -> Optional[float]:
    """Host ms a batch of the quiet pass in the spans `names`, less the
    ms in the spans `less`; None without a span of `names`."""
    q = _quiet(r)
    if q is None:
        return None
    recs, batches, _ = q
    names, less = set(names), set(less)
    mine = [x for x in recs if x["batch"] in batches]
    if not any(x["name"] in names for x in mine):
        return None
    ns = sum(x["end_ns"] - x["start_ns"] for x in mine if x["name"] in names)
    ns -= sum(x["end_ns"] - x["start_ns"] for x in mine if x["name"] in less)
    return 1e-6 * ns / len(batches)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]
             ) -> float:
    """Seconds common to two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(r, names: Iterable[str]) -> Optional[float]:
    """The share (%) of the quiet pass's steady window in which the
    device was idle while a dispatching thread was inside one of the
    spans `names`; None without a span of `names` on that thread."""
    q = _quiet(r)
    if q is None:
        return None
    recs, _, threads = q
    names = set(names)
    iv = _union([(1e-9 * x["start_ns"], 1e-9 * x["end_ns"]) for x in recs
                 if x["thread"] in threads and x["name"] in names])
    if not iv:
        return None
    quiet = r["trace"].quiet
    lo, hi = quiet.window
    return 100.0 * _overlap(trace.gaps(quiet), iv) / (hi - lo)
