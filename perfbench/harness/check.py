"""Whether the timed path produced the right output.

After the window has closed, a sample of the files it served (drawn from
the seed, always with the pool's longest file in it) is run again through
the system's plain reference (its ``reference_outputs``), from the same
inputs and the same weights, and the served outputs are held against the
reference's by the system's ``NUMBERS``.  The system's ``sums`` gives,
for one file, each number's summed squared gap and summed squared
reference; here each number is pooled over the sample (the root of the
summed squared gap of all its files over their summed squared reference)
and held to the cell's limit in ``perfbench/limits/<cell>.json``.

Pooled, not the worst file: a file's gap mixes the bands by that file's
energy, and a quiet, pause-heavy file read several times its neighbours
while the model's gap was the same (``PERF.md``).  A sampled file that
raised, or an output the system's ``sums`` finds unusable (``nan``), is
not correct whatever the numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np


def sample_indices(pool_sizes: List[Dict], n: int, seed: int) -> List[int]:
    """Pool indices of the sample: the longest file and ``n - 1`` others
    drawn from ``seed``."""
    longest = max(pool_sizes, key=lambda s: s["seconds"])["index"]
    rest = [s["index"] for s in pool_sizes if s["index"] != longest]
    rng = np.random.default_rng([int(seed), 2])
    return [longest] + [int(i) for i in rng.choice(rest, size=min(n - 1, len(rest)),
                                                    replace=False)]


def pooled(files: List[Dict[str, float]], numbers: Sequence[str]) -> Dict[str, float]:
    """Each number over a set of files: the root of their summed squared
    gap over their summed squared reference."""
    if not files:
        return {k: float("nan") for k in numbers}
    out = {}
    for k in numbers:
        gap2 = sum(f[f"{k}_gap2"] for f in files)
        ref2 = sum(f[f"{k}_ref2"] for f in files)
        # a band with no bin in it gaps by nothing
        out[k] = math.sqrt(gap2 / ref2) if ref2 > 0 else (0.0 if gap2 == 0 else math.inf)
    return out


@dataclasses.dataclass
class Verdict:
    correct: bool
    numbers: Dict[str, float]        # each number pooled over the sample, in the system's order
    limits: Dict[str, float]
    compared: int
    reason: str = ""

    def lines(self) -> List[str]:
        out = [f"{k} {v:.6g} limit {self.limits[k]:.6g}" for k, v in self.numbers.items()]
        out.append(f"files compared {self.compared}")
        return out

    def record(self) -> Dict:
        """The result line's ``checks``: each number beside its limit."""
        rec = {k: {"value": v, "limit": self.limits[k]} for k, v in self.numbers.items()}
        rec["files_compared"] = self.compared
        return rec


def judge(files: List[Dict[str, float]], limits: Dict[str, float], numbers: Sequence[str],
          failed: int, expected: int) -> Verdict:
    """Each of the system's ``numbers``, pooled over the compared files,
    held to its limit."""
    pooled_numbers = pooled(files, numbers)
    ok = bool(files) and all(math.isfinite(pooled_numbers[k]) and pooled_numbers[k] <= limits[k]
                             for k in numbers)
    reason = ""
    if failed:
        ok, reason = False, f"{failed} call(s) raised"
    elif not files:
        reason = "no sampled file was served"
    elif len(files) < expected:
        reason = f"{expected - len(files)} sampled file(s) not served in the window"
    return Verdict(ok, pooled_numbers, dict(limits), len(files), reason)
