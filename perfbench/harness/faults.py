"""Faults planted under the timed path, for the tests and the calibration
that show the output comparison fails them.

Each fault wraps a method of the cell's ``FlashSRPipeline`` instance
(the program's files are untouched) and is undone by ``undo``:

* ``state_unchanged``: the model step hands its input back: the
  vocoder's wave is the input chunk itself, so nothing is synthesised;
* ``half_batch``: half of each chunk batch is left out, its rows filled
  with the mean of the rows computed;
* ``answer_altered``: the vocoder's wave of the last chunk row is
  negated where it is produced.

The exchange between chips does not exist in a one-chip cell.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

NAMES = ("state_unchanged", "half_batch", "answer_altered")


def _state_unchanged(pipe) -> Callable:
    orig = pipe.synthesize

    def synthesize(x):
        mel_hr, _ = orig(x)
        return mel_hr, x
    return synthesize


def _answer_altered(pipe) -> Callable:
    orig = pipe.synthesize

    def synthesize(x):
        mel_hr, wav = orig(x)
        wav = wav.clone()
        wav[-1] = -wav[-1]
        return mel_hr, wav
    return synthesize


def _half_batch(pipe) -> Callable:
    orig = pipe.chunk_forward

    def chunk_forward(chunks, lowpass_input=False):
        keep = max(1, chunks.shape[0] // 2)
        y = orig(chunks[:keep], lowpass_input=lowpass_input)
        rest = y.mean(dim=0, keepdim=True).expand((chunks.shape[0] - keep,) + y.shape[1:])
        return torch.cat([y, rest])
    return chunk_forward


_PLANT: Dict[str, tuple] = {"state_unchanged": ("synthesize", _state_unchanged),
                            "half_batch": ("chunk_forward", _half_batch),
                            "answer_altered": ("synthesize", _answer_altered)}


def plant(pipe, name: str) -> None:
    attr, make = _PLANT[name]
    setattr(pipe, attr, make(pipe))


def undo(pipe) -> None:
    for attr in ("synthesize", "chunk_forward"):
        vars(pipe).pop(attr, None)
