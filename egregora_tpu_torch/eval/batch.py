"""Batched evaluation: a whole ``[P, T]`` batch of mono pairs per call.

Counterpart of ``egregora_tpu/eval/batch.py``, whose ``vmap`` over pairs
becomes a batch axis written out: every engine here reduces the last
axis, so the K-weighting (the K4 kernel on the card) runs once on
``[P, T]`` per reading, not once a pair.  Readings come back as ``[P]``
tensors under the per-pair keys.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .align import apply_frac_delay, xcorr_delay
from .loudness import loudness_report
from .metrics import lsd_sisdr_report
from .nulltest import gain_match, null_test


def evalpack_report_batch(a: torch.Tensor, b: torch.Tensor, sr: int, n_fft: int = 2048,
                          hop: int = 512, compute_true_peak: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """SI-SDR/LSD of each pair and the loudness readings of ``b`` (the
    processed side)."""
    rep = dict(lsd_sisdr_report(a, b, n_fft=n_fft, hop=hop))
    rep.update(loudness_report(b[:, None, :], sr, compute_true_peak=compute_true_peak))
    return rep


def nullsuite_batch(a: torch.Tensor, b: torch.Tensor, sr: int, max_shift: int = 9600,
                    gain_mode: str = "RMS", least_squares_scale: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GCC-PHAT align, gain match and null test of each pair: ``(null [P,
    T], metrics)`` with ``delay_samples`` and ``gain_db`` added."""
    lag = xcorr_delay(a, b, max_shift=max_shift)
    aligned = apply_frac_delay(b[:, None, :], -lag)
    matched, gain_db, _, _ = gain_match(a[:, None, :], aligned, sr, mode=gain_mode)
    null, metrics = null_test(a[:, None, :], matched, sr,
                              least_squares_scale=least_squares_scale)
    metrics = dict(metrics)
    metrics["delay_samples"] = lag
    metrics["gain_db"] = gain_db
    return null[:, 0], metrics
