"""Spans and counters of the port, on the clock of torch.profiler's traces.

    from rrnet_torch.utils import tracing

    with tracing.span("eval.copy"):
        tracing.count("eval.d2h_syncs")
        ...

Tracing is off unless `enable()` was called or a `torch.profiler`
session is active. Off, `span` returns one shared no-op context after a
single check and `count` returns at once, so a span costs about a
function call. On, a span enters a profiler record function of its
name, so that it shows as an operator of its own thread in every
profiler trace, and, when it closes, appends one record to a bounded
in-memory store:

    {"id", "name", "attrs", "thread", "parent", "batch",
     "start_ns", "end_ns", "counts"}

`thread` is `threading.get_ident()`; `parent` is the id of the
innermost span open on the same thread when this one opened (None at the
top); `batch` is the id set by `batch()` on that thread; `counts` holds
what `count` added while this was the innermost open span of its thread.
Start and end come from `time.time_ns()`, the clock of the host and
device events of torch.profiler's Kineto traces, so a span can be set
against the device's activity in the same trace. No span or counter
reads a device value, so none makes the host wait on the device.

`records()`, `clear()` and `write(path)` read, empty and export the
store (JSON lines). `profiled(dir)` runs a CPU (and, with a card, CUDA)
profiler session and writes its Chrome trace and the session's spans
into `dir`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# A record function of the function scope, where `torch.profiler.
# record_function` opens one of the user scope: for a user-scope range
# under CPU and CUDA activity Kineto adds a `gpu_user_annotation` event
# on the device's timeline, spanning the kernels launched inside it, and
# a reader that takes every device event as device work (the benchmark's
# `rrbench/trace.py`) would then count the span's idle stretches as busy.
# It is also ~15x cheaper to enter.
_RecordFunction = torch._C._profiler._RecordFunctionFast

CAPACITY = 1 << 16          # records kept; the oldest are dropped first

_store: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()  # .stack: open spans; .batch: the batch id
_ids = itertools.count()
_NOOP = contextlib.nullcontext()
_enabled = False


def enable() -> None:
    """Record spans and counts whether or not a profiler runs."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record only while a torch.profiler session is active."""
    global _enabled
    _enabled = False


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("rec", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"id": next(_ids), "name": name, "attrs": attrs,
                    "counts": {}}

    def __enter__(self):
        st = _stack()
        rec = self.rec
        rec["thread"] = threading.get_ident()
        rec["parent"] = st[-1].rec["id"] if st else None
        rec["batch"] = getattr(_local, "batch", None)
        self._rf = _RecordFunction(rec["name"])
        self._rf.__enter__()
        rec["start_ns"] = time.time_ns()
        st.append(self)
        return self

    def __exit__(self, *exc):
        self.rec["end_ns"] = time.time_ns()
        _stack().pop()
        self._rf.__exit__(*exc)
        _store.append(self.rec)
        return False


def span(name: str, **attrs):
    """A context manager timing the block as `name` (module docstring);
    `attrs` are kept in the record."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span of this
    thread (nothing when tracing is off or no span is open)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    st = getattr(_local, "stack", None)
    if st:
        counts = st[-1].rec["counts"]
        counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def batch(batch_id: Optional[int]):
    """Give the spans this thread opens inside the block `batch_id`. Set
    whether or not tracing is on, so that a profiler started later in
    the block still sees it."""
    before = getattr(_local, "batch", None)
    _local.batch = batch_id
    try:
        yield
    finally:
        _local.batch = before


def records() -> List[dict]:
    """The stored records, oldest first."""
    return list(_store)


def clear() -> None:
    _store.clear()


def write(path: str, since_ns: int = 0) -> str:
    """Write the records that started at or after `since_ns` as JSON
    lines; returns `path`."""
    with open(path, "w") as f:
        for rec in records():
            if rec["start_ns"] >= since_ns:
                f.write(json.dumps(rec) + "\n")
    return path


class profiled:
    """One torch.profiler session (CPU activity, and CUDA activity when
    a card is present) for the port's tools. `stop()` writes
    `dir/trace.json` (the Chrome trace, spans included as operators of
    their threads) and `dir/spans.jsonl` (the session's records) and
    returns the trace's path. Use as `with profiled(dir):`
    or through `start()`/`stop()`."""

    def __init__(self, directory: str):
        self.directory = directory
        self._prof = None
        self._t0 = 0

    def start(self) -> "profiled":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._t0 = time.time_ns()
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        return self

    def stop(self) -> str:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, "trace.json")
        prof.export_chrome_trace(path)
        write(os.path.join(self.directory, "spans.jsonl"), self._t0)
        return path

    def __enter__(self) -> "profiled":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

