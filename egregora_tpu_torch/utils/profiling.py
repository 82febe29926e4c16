"""Tracing and profiling.

Counterpart of ``egregora_tpu/utils/profiling.py``, two layers:

* ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (the CPU activity, and the CUDA activity where a card is present) that
  writes one Chrome trace, ``<logdir>/<host>_<pid>.<ns>.pt.trace.json``,
  readable in Perfetto or ``chrome://tracing``; the card's kernels appear
  in it by name.
* ``NodeTimer``: per-node wall timing for the workflow executor; every
  node execution records ``(node_type, wall_s)`` and ``summary()`` exports
  a plain dict.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List


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


class NodeTimer:
    """Thread-safe wall-clock accumulator keyed by node type."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, key: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._times[key].append(dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for k, v in self._times.items():
                out[k] = {
                    "calls": float(len(v)),
                    "total_s": float(sum(v)),
                    "mean_s": float(sum(v) / len(v)),
                    "max_s": float(max(v)),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._times.clear()


GLOBAL_TIMER = NodeTimer()
