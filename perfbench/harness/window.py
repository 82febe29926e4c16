"""The measured window: one client, files back to back (a closed loop).

The node is called as a ComfyUI graph calls it, ``run(audio,
lowpass_input=False, output_sr="48000")``, on the pool's files in order
(again from the start where the pool runs out).  No file is issued once
``seconds`` have passed; the file in flight then completes and counts.
Each call's wall time is the host clock from the call to the returned
AUDIO dict, whose waveform is already on the host.  The outputs of the
sampled pool indices are kept, the first time each is served.
"""
from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import Dict, List, Set

import numpy as np

from .traffic import Item

REQ_SR = 48000
CHUNK, HOP = 245760, 221760


def chunk_rows(item: Item) -> int:
    """Chunk rows of one call: chunks of the 48 kHz input times channels."""
    total = -(-item.samples.shape[-1] * REQ_SR // item.sr) if item.sr != REQ_SR \
        else item.samples.shape[-1]
    per_channel = 1 if total <= CHUNK else 1 + -(-(total - CHUNK) // HOP)
    return per_channel * item.samples.shape[0]


@dataclasses.dataclass
class Call:
    index: int          # pool index
    start: float        # host clock, seconds
    end: float
    seconds: float      # of input audio
    rows: int
    ok: bool

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Window:
    t0: float
    calls: List[Call]
    outputs: Dict[int, np.ndarray]

    @property
    def t_end(self) -> float:
        return self.calls[-1].end if self.calls else self.t0

    @property
    def failed(self) -> int:
        return sum(not c.ok for c in self.calls)


def call_once(node, item: Item) -> np.ndarray:
    out = node.run(item.audio(), False, "48000")[0]
    return out["waveform"][0].numpy()


def run(node, pool: List[Item], seconds: float, keep: Set[int]) -> Window:
    calls, outputs = [], {}
    t0 = time.perf_counter()
    i = 0
    while True:
        item = pool[i % len(pool)]
        s = time.perf_counter()
        try:
            y = call_once(node, item)
            ok = True
        except Exception:            # a failed call is counted and reported, the loop goes on
            traceback.print_exc(file=sys.stderr)
            y, ok = None, False
        e = time.perf_counter()
        calls.append(Call(item.index, s, e, item.seconds, chunk_rows(item), ok))
        if ok and item.index in keep and item.index not in outputs:
            outputs[item.index] = y
        i += 1
        if e - t0 >= seconds:
            return Window(t0, calls, outputs)
