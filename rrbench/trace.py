"""The device trace of a stretch of work, and what is read from it.

`traced(fn)` runs `fn` twice under `torch.profiler`. The first time it
records CUDA activity alone, which costs the host next to nothing: every
device kernel and memory operation with its start and end. The second
time it records CPU activity too, so that each idle gap of that pass can
be labelled by the host operator that was running when the gap began (on
the thread that launched the most kernels); recording every operator
slows the host, so the busy share is read from the first pass only. The
steady window of a pass is the stretch from its first device operation
to its last with a tenth cut off each end, where the pipeline fills and
drains. From the first pass: the busy seconds (the union of device
operations) and the device time by operation name; from the second: the
idle seconds by what the host was doing.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

TRIM = 0.1


class Pass(NamedTuple):
    device: List[Tuple[str, float, float]]    # (name, start s, end s)
    host: List[Tuple[str, float, float]]      # launching thread's ops
    window: Tuple[float, float]               # the steady stretch


class Trace(NamedTuple):
    quiet: Pass        # CUDA activity alone
    labelled: Pass     # CPU and CUDA activity


def _events(prof):
    """(kind, name, start ns, end ns, thread) of every event; kind is
    "device", "runtime" or "cpu"."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out.append(("device", e.name(), start, end, -1))
        elif e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out.append(("runtime", e.name(), start, end, e.start_thread_id()))
        else:
            out.append(("cpu", e.name(), start, end, e.start_thread_id()))
    return out


def _pass(fn, acts) -> Pass:
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = _events(prof)
    dev = sorted(((n, s * 1e-9, e * 1e-9) for k, n, s, e, _ in ev
                  if k == "device"), key=lambda d: d[1])
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    launches = Counter(t for k, _, _, _, t in ev if k == "runtime")
    main = launches.most_common(1)[0][0] if launches else None
    host = sorted(((n, s * 1e-9, e * 1e-9) for k, n, s, e, t in ev
                   if k == "cpu" and t == main), key=lambda h: h[1])
    t0, t1 = dev[0][1], max(d[2] for d in dev)
    cut = TRIM * (t1 - t0)
    return Pass(dev, host, (t0 + cut, t1 - cut))


def traced(fn: Callable[[], None]) -> Trace:
    cuda = torch.profiler.ProfilerActivity.CUDA
    cpu = torch.profiler.ProfilerActivity.CPU
    return Trace(_pass(fn, [cuda]), _pass(fn, [cpu, cuda]))


def _clipped(tr: Pass):
    lo, hi = tr.window
    for name, s, e in tr.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            yield name, s, e


def busy_s(tr: Trace) -> float:
    """Seconds of the quiet pass's window in which some device
    operation ran."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(_clipped(tr.quiet), key=lambda d: d[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def window_s(tr: Trace) -> float:
    return tr.quiet.window[1] - tr.quiet.window[0]


def gaps(tr: Pass) -> List[Tuple[float, float]]:
    """The idle stretches of the window, (start, end)."""
    out, at = [], tr.window[0]
    for _, s, e in sorted(_clipped(tr), key=lambda d: d[1]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if tr.window[1] > at:
        out.append((at, tr.window[1]))
    return out


def _host_label(tr: Pass, starts: List[float], t: float) -> str:
    """The innermost host operator of the launching thread running at
    `t`: the one that started last among those covering it (looked for
    among the 256 that started last before `t`)."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(tr.host[max(0, i - 256):i]):
        if e >= t:
            return name
    return "host outside any operator"


def idle_by_host(tr: Trace, top: int = 10) -> List[List]:
    """Idle seconds of the labelled pass summed by what the host was
    doing, longest first."""
    lab = tr.labelled
    starts = [s for _, s, _ in lab.host]
    acc: Dict[str, float] = defaultdict(float)
    for s, e in gaps(lab):
        acc[_host_label(lab, starts, s)] += e - s
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            [:top]]


def device_ops(tr: Trace, top: int = 10) -> List[List]:
    """Device seconds in the quiet pass's window by operation name, most
    first."""
    acc: Dict[str, float] = defaultdict(float)
    for name, s, e in _clipped(tr.quiet):
        acc[name] += e - s
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
            [:top]]


def kernel_calls(tr: Trace, needle: str) -> List[float]:
    """Durations (s) of every device operation of the quiet pass whose
    name holds `needle`."""
    return [e - s for name, s, e in tr.quiet.device if needle in name]
