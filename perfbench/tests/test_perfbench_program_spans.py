"""The readers of the program's own spans, ``wire_idle_ms`` and
``forward_idle_ms_per_chunk``, against idle times worked out by hand on a
made-up window: device intervals on a known timeline and span records in
the program's buffer, on one clock."""
import types
from collections import deque

import numpy as np
import pytest

from egregora_tpu_torch.utils import profiling
from perfbench.harness import spec
from perfbench.harness.trace import Reduced

BASE = 100_000_000_000           # the window opens at 100 s (ns)


def ns(ms: float) -> int:
    return BASE + round(ms * 1e6)


def trace(dev_ms):
    dev = np.asarray([[100.0 + a / 1e3, 100.0 + b / 1e3] for a, b in dev_ms]).reshape(-1, 2)
    return Reduced(100.0, 101.0, {}, dev, ["k"] * len(dev), {}, {})


# (name, call, start ms, end ms[, rows]); device busy at 100-150, 300-400 and 620-700 ms
RECORDS = [
    ("egr.node.upscale", 0, -1000, -500), ("egr.node.audio_in", 0, -1000, -800),  # before
    ("egr.process", 0, -790, -510, 7), ("egr.forward", 0, -700, -600),            # before
    ("egr.node.upscale", 1, 0, 500),
    ("egr.node.audio_in", 1, 0, 50),            # idle 50
    ("egr.process", 1, 50, 450, 3),
    ("egr.wire.encode", 1, 50, 80),             # idle 30
    ("egr.wire.h2d", 1, 80, 120),               # busy 100-120: idle 20
    ("egr.forward", 1, 120, 420),               # busy 120-150 and 300-400: idle 170
    ("egr.wire.quantise", 1, 420, 440),         # idle 20
    ("egr.node.audio_out", 1, 450, 500),        # idle 50
    ("egr.node.upscale", 2, 600, 900),
    ("egr.node.audio_in", 2, 600, 610),         # idle 10
    ("egr.process", 2, 610, 800, 2),
    ("egr.forward", 2, 610, 750),               # busy 620-700: idle 60
    ("egr.node.audio_out", 2, 800, 900),        # idle 100
    ("egr.forward", 3, 950, 990),               # its call's process lies outside
]
DEV = [(100, 150), (300, 400), (620, 700)]


@pytest.fixture()
def records(monkeypatch):
    recs = deque()
    for i, (name, call, a, b, *rows) in enumerate(RECORDS):
        counts = {"rows": rows[0]} if rows else {}
        recs.append(profiling.SpanRecord(i, name, call, None, ns(a), ns(b), {}, counts))
    monkeypatch.setattr(profiling, "_records", recs)
    return recs


def ctx(t):
    return types.SimpleNamespace(trace=t)


def test_wire_idle_ms_by_hand(records):
    # (50 + 30 + 20 + 20 + 50) + (10 + 100) ms over two calls
    for name in ("wire_idle_ms", "wire_idle_ms.music"):
        assert spec.reader(name)(ctx(trace(DEV))) == pytest.approx(140.0, abs=1e-3)


def test_forward_idle_ms_per_chunk_by_hand(records):
    # (170 + 60) ms over the 3 + 2 rows counted on the same calls' egr.process
    for name in ("forward_idle_ms_per_chunk", "forward_idle_ms_per_chunk.music"):
        assert spec.reader(name)(ctx(trace(DEV))) == pytest.approx(46.0, abs=1e-3)
    for r in records:
        r.counts.clear()                                    # no rows counted
    assert spec.reader("forward_idle_ms_per_chunk")(ctx(trace(DEV))) is None


def test_none_where_nothing_was_recorded(records, monkeypatch):
    readers = [spec.reader(n) for n in ("wire_idle_ms", "forward_idle_ms_per_chunk")]
    for read in readers:
        assert read(ctx(None)) is None
        assert read(ctx(trace([]))) is None                 # no device events
    records.clear()
    for read in readers:
        assert read(ctx(trace(DEV))) is None                # no records
    monkeypatch.delattr(profiling, "spans")                 # a program without spans
    for read in readers:
        assert read(ctx(trace(DEV))) is None
