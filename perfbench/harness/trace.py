"""The traced window reduced to what the per-layer readers need.

From the profiler's raw (kineto) events:

* device activity: every kernel, copy and set event on the card, as
  intervals; ``busy_s`` is the length of their union;
* spans: the ``pb.*`` ranges that the system's spans name (outermost
  first, their ``NAMES``) on the host's timeline;
* attribution: a device event belongs to every span that encloses the
  host call that launched it (matched by the CUDA correlation id of the
  runtime call; failing that, the launching operator's start), so a
  layer's device time is the sum of the events launched under its span.

All times are seconds on the profiler's clock, which it shares between
host and device events.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

import numpy as np

@dataclasses.dataclass
class Reduced:
    t0: float                                  # window start
    t1: float                                  # window end
    spans: Dict[str, np.ndarray]               # name -> [n, 2] host intervals, sorted
    dev: np.ndarray                            # [m, 2] device intervals (start, end), sorted
    dev_names: List[str]
    under: Dict[str, np.ndarray]               # span name -> bool [m], launched under it
    kinds: Dict[str, int]                      # event counts by kind, for the record
    nesting: Tuple[str, ...] = ()              # the span names, outermost first

    def __post_init__(self):
        self.merged = merge(self.dev)          # the device's busy intervals, disjoint

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_in(self, a: float, b: float) -> float:
        """Seconds of device activity (union) inside ``[a, b]``."""
        m = self.merged
        seg = m[np.searchsorted(m[:, 1], a, side="right"): np.searchsorted(m[:, 0], b)]
        return float(np.sum(np.clip(seg[:, 1], a, b) - np.clip(seg[:, 0], a, b)))

    @property
    def busy_s(self) -> float:
        return self.busy_in(self.t0, self.t1)

    def device_time(self, *names: str) -> float:
        """Summed duration of the device events launched under any of
        ``names``."""
        mask = np.zeros(len(self.dev), bool)
        for n in names:
            mask |= self.under.get(n, np.zeros(len(self.dev), bool))
        d = self.dev[mask]
        return float(np.sum(d[:, 1] - d[:, 0])) if len(d) else 0.0

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        tot: Dict[str, float] = collections.defaultdict(float)
        for (s, e), name in zip(self.dev, self.dev_names):
            tot[name] += e - s
        return sorted(tot.items(), key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """Idle time of the card between its events, summed by the
        innermost span the host was in at the middle of each gap."""
        if not len(self.dev):
            return [("no device activity", self.window_s)]
        starts = np.concatenate([[self.t0], self.merged[:, 1]])
        ends = np.concatenate([self.merged[:, 0], [self.t1]])
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        labels = ("outside the node",) + tuple(self.nesting)
        where = np.zeros(len(starts), int)
        for i, n in enumerate(self.nesting, 1):     # outermost first: the innermost wins
            spans = self.spans.get(n)
            if spans is not None:
                where[_contained(spans, 0.5 * (starts + ends))] = i
        tot = np.bincount(where, weights=ends - starts, minlength=len(labels))
        out = [(labels[i], float(tot[i])) for i in np.nonzero(tot)[0]]
        return sorted(out, key=lambda kv: -kv[1])[:k]


def merge(iv: np.ndarray) -> np.ndarray:
    """Union of intervals ``[n, 2]`` as sorted disjoint intervals."""
    iv = np.asarray(iv, dtype=np.float64).reshape(-1, 2)
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > reach[:-1]])
    first = np.nonzero(new)[0]
    last = np.concatenate([first[1:] - 1, [len(iv) - 1]])
    return np.stack([iv[first, 0], reach[last]], axis=1)


def _contained(spans: np.ndarray, t: np.ndarray) -> np.ndarray:
    if not len(spans):
        return np.zeros(len(t), bool)
    i = np.searchsorted(spans[:, 0], t, side="right") - 1
    ok = i >= 0
    out = np.zeros(len(t), bool)
    out[ok] = t[ok] < spans[i[ok], 1]
    return out


def reduce_window(prof, names) -> Reduced:
    """Reduce a finished ``torch.profiler.profile`` to a ``Reduced`` over
    the ``pb.window`` span, which the harness puts around the window, by
    the span ``names``, outermost first (the system's spans' ``NAMES``)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans: Dict[str, list] = {n: [] for n in tuple(names) + ("pb.window",)}
    launch_at: Dict[int, int] = {}          # runtime call's correlation id -> start
    op_at: Dict[int, int] = {}              # operator's id -> start
    dev, dev_names, dev_corr, dev_link = [], [], [], []
    kinds: Dict[str, int] = collections.Counter()
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name in spans:
                spans[name].append((e.start_ns(), e.end_ns()))
            elif name.startswith("cu"):
                launch_at[e.correlation_id()] = e.start_ns()
                kinds["runtime"] += 1
            else:
                op_at[e.correlation_id()] = e.start_ns()
            continue
        kinds["device"] += 1
        if e.is_user_annotation() or name.startswith("pb."):    # the spans' device-side copies
            continue
        dev.append((e.start_ns(), e.end_ns()))
        dev_names.append(name)
        dev_corr.append(e.correlation_id())
        dev_link.append(e.linked_correlation_id())
    sp = {n: np.asarray(sorted(v), dtype=np.float64).reshape(-1, 2) * 1e-9 for n, v in spans.items()}
    if len(sp["pb.window"]) != 1:
        raise RuntimeError(f"the trace holds {len(sp['pb.window'])} pb.window spans, not one")
    t0, t1 = sp.pop("pb.window")[0]
    launched = np.array([launch_at.get(c, op_at.get(l, s)) for c, l, (s, _) in
                         zip(dev_corr, dev_link, dev)], dtype=np.float64) * 1e-9
    d = np.asarray(dev, dtype=np.float64).reshape(-1, 2) * 1e-9
    keep = (d[:, 1] > t0) & (d[:, 0] < t1)
    d, launched = d[keep], launched[keep]
    dev_names = [n for n, k in zip(dev_names, keep) if k]
    order = np.argsort(d[:, 0]) if len(d) else np.zeros(0, int)
    d, launched = d[order], launched[order]
    dev_names = [dev_names[i] for i in order]
    under = {n: _contained(sp[n], launched) for n in names}
    return Reduced(t0, t1, sp, d, dev_names, under, dict(kinds), tuple(names))
