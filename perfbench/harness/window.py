"""The measured window: one client, files back to back (a closed loop).

The system's ``call`` (the node called as a ComfyUI graph calls it) runs
on the pool's files in order (again from the start where the pool runs
out).  No file is issued once ``seconds`` have passed; the file in flight
then completes and counts.  Each call's wall time is the host clock from
the call to its return, with what the check compares on the host.  The
outputs of the sampled pool indices are kept, the first time each is
served.
"""
from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import Any, Dict, List, Set

from .traffic import Item


@dataclasses.dataclass
class Call:
    index: int          # pool index
    start: float        # host clock, seconds
    end: float
    seconds: float      # of input audio
    rows: int           # the system's units of work in the call
    ok: bool

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Window:
    t0: float
    calls: List[Call]
    outputs: Dict[int, Any]     # pool index -> what the system's call returned

    @property
    def t_end(self) -> float:
        return self.calls[-1].end if self.calls else self.t0

    @property
    def failed(self) -> int:
        return sum(not c.ok for c in self.calls)


def run(served, pool: List[Item], seconds: float, keep: Set[int]) -> Window:
    """The window over ``served``, the system's built object."""
    calls, outputs = [], {}
    t0 = time.perf_counter()
    i = 0
    while True:
        item = pool[i % len(pool)]
        s = time.perf_counter()
        try:
            y = served.call(item)
            ok = True
        except Exception:            # a failed call is counted and reported, the loop goes on
            traceback.print_exc(file=sys.stderr)
            y, ok = None, False
        e = time.perf_counter()
        calls.append(Call(item.index, s, e, item.seconds, served.rows(item), ok))
        if ok and item.index in keep and item.index not in outputs:
            outputs[item.index] = y
        i += 1
        if e - t0 >= seconds:
            return Window(t0, calls, outputs)
