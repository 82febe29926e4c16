"""Tracing and profiling.

Counterpart of ``egregora_tpu/utils/profiling.py``, three layers:

* ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (the CPU activity, and the CUDA activity where a card is present) that
  writes one Chrome trace, ``<logdir>/<host>_<pid>.<ns>.pt.trace.json``,
  readable in Perfetto or ``chrome://tracing``; the card's kernels appear
  in it by name, and so do the program's spans.
* ``span(name, **attrs)`` and ``count(name, n)``: the program's own spans
  and counters at its layer boundaries (``egr.*``).  They record only
  while a ``torch.profiler`` session records in the process, or inside
  ``recording()``; otherwise ``span`` returns one shared no-op context
  after a single flag check, and ``count`` returns.  A recorded span is a
  ``record_function`` range in the profiler's trace and a ``SpanRecord``
  in a bounded in-memory buffer, stamped in Unix-epoch nanoseconds, the
  clock the profiler stamps its host and device events with, so that a
  record can be laid over the card's activity.  ``spans(t0_ns, t1_ns)``
  reads the records of an interval back, ``counters()`` the totals.
* ``NodeTimer``: per-node wall timing for the workflow executor: running
  totals a node type, and each node execution a span ``egr.node.<type>``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

MAX_RECORDS = 1 << 20        # ~700 node calls x ~25 spans fit many times over


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profiler trace of the block, written into ``logdir`` on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    Path(logdir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One recorded span."""
    index: int                   # order in which spans were opened, process-wide
    name: str
    call: int                    # id of the outermost enclosing span: one node call
    parent: Optional[int]        # ``index`` of the enclosing span's record
    t0_ns: int                   # Unix-epoch ns, taken inside the profiler's event
    t1_ns: Optional[int]         # None while the span is open
    attrs: Dict[str, Any]
    counts: Dict[str, int]


_records: Deque[SpanRecord] = deque(maxlen=MAX_RECORDS)
_totals: Dict[str, int] = {}
_lock = threading.Lock()
_open = threading.local()        # .stack: this thread's open spans, innermost last
_index = itertools.count()
_calls = itertools.count(1)
_forced = 0                      # depth of open ``recording()`` blocks


class _Off:
    """The span returned while nothing records: one shared instance."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> List[SpanRecord]:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Span:
    __slots__ = ("_name", "_attrs", "_rf", "_rec")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self._name, self._attrs = name, attrs

    def __enter__(self) -> "_Span":
        self._rf = record_function(self._name)
        self._rf.__enter__()
        t0 = time.time_ns()
        stack = _stack()
        up = stack[-1] if stack else None
        rec = SpanRecord(next(_index), self._name, up.call if up else next(_calls),
                         up.index if up else None, t0, None, self._attrs, {})
        self._rec = rec
        _records.append(rec)
        stack.append(rec)
        return self

    def __exit__(self, *exc) -> bool:
        self._rec.t1_ns = time.time_ns()
        _stack().pop()
        return self._rf.__exit__(*exc)


def is_recording() -> bool:
    """Whether spans and counts record now: a ``torch.profiler`` session
    records in the process, or a ``recording()`` block is open."""
    return bool(_forced or _autograd_profiler._is_profiler_enabled)


def span(name: str, **attrs):
    """A context manager over one layer step: a profiler range and a
    ``SpanRecord`` while recording, else the shared no-op."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the innermost open span's ``counts[name]`` and to the
    process's total, while recording."""
    if not (_forced or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[name] = c.get(name, 0) + n
    with _lock:
        _totals[name] = _totals.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counts for the block without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def spans(t0_ns: int, t1_ns: int) -> List[SpanRecord]:
    """The closed records that lie inside ``[t0_ns, t1_ns]``, in the order
    they were opened (the buffer keeps the last ``MAX_RECORDS``)."""
    return [r for r in list(_records)
            if r.t1_ns is not None and r.t0_ns >= t0_ns and r.t1_ns <= t1_ns]


def counters() -> Dict[str, int]:
    """The counts' totals since the process started."""
    with _lock:
        return dict(_totals)


class NodeTimer:
    """Thread-safe wall time keyed by node type: calls, total and
    longest, kept as running totals.  The clock is the host's: for work a
    node leaves queued on the card it times the enqueue; the span it opens
    puts the node on the profiler's timeline beside the card's kernels."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, List[float]] = {}      # key -> [calls, total_s, max_s]

    @contextlib.contextmanager
    def measure(self, key: str) -> Iterator[None]:
        with span("egr.node." + key):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    s = self._stats.setdefault(key, [0, 0.0, 0.0])
                    s[0] += 1
                    s[1] += dt
                    s[2] = max(s[2], dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"calls": float(n), "total_s": float(tot), "mean_s": float(tot / n),
                        "max_s": float(mx)}
                    for k, (n, tot, mx) in self._stats.items()}

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


GLOBAL_TIMER = NodeTimer()
