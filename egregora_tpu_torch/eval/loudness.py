"""BS.1770-style loudness: integrated LUFS with relative gating, the
momentary and short-term series, the loudness range and the true peak.

Counterpart of ``egregora_tpu/eval/loudness.py``, with the reference
meter's numbers: its K-weighting approximation (``ops.iir.k_weight``,
which runs the K4 kernel on the card), 400 ms / 100 ms momentary blocks
with the -0.691 offset and a -10 LU relative gate, 3 s / 1 s short-term
blocks, the LRA's percentile gate, and a 4x-oversampled true peak.
Signals are ``[..., C, N]``: leading axes are a batch, and each reading
comes back with the batch's shape.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.iir import k_weight
from ..ops.resample import oversample as _oversample
from ..ops.stft import frame


def rms_db(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``10 log10(mean(x^2) + 1e-20)`` over every sample, or over ``dim``."""
    sq = torch.square(x.float())
    return 10.0 * torch.log10((sq.mean() if dim is None else sq.mean(dim)) + 1e-20)


def _block_mean_squares(mono: torch.Tensor, sr: int, window_s: float,
                        hop_s: float) -> torch.Tensor:
    """Mean square of each block ``[..., frames]``; a signal shorter than
    one block is one block of its own samples (the zero padding's
    dilution undone)."""
    blk = max(1, int(round(window_s * sr)))
    hop = max(1, int(round(hop_s * sr)))
    n = mono.shape[-1]
    ms = torch.square(frame(mono, blk, hop)).mean(-1)
    if n < blk:
        ms = ms * (blk / float(max(n, 1)))
    return ms


def _kw_mono(samples_cn: torch.Tensor, sr: int) -> torch.Tensor:
    return k_weight(sr, samples_cn).mean(-2)


def integrated_lufs(samples_cn: torch.Tensor, sr: int) -> torch.Tensor:
    """Integrated loudness with the -10 LU relative gate (all blocks when
    none passes)."""
    ms = _block_mean_squares(_kw_mono(samples_cn, sr), sr, 0.400, 0.100) + 1e-20
    gate = -0.691 + 10.0 * torch.log10(ms.mean(-1)) - 10.0
    mask = (-0.691 + 10.0 * torch.log10(ms)) >= gate[..., None]
    w = torch.where(mask.any(-1, keepdim=True), mask.to(ms.dtype), torch.ones_like(ms))
    return -0.691 + 10.0 * torch.log10((ms * w).sum(-1) / w.sum(-1))


def lufs_series(samples_cn: torch.Tensor, sr: int, window_s: float,
                hop_s: float) -> torch.Tensor:
    """Momentary (0.4 s / 0.1 s) or short-term (3 s / 1 s) loudness
    series ``[..., frames]``."""
    ms = _block_mean_squares(_kw_mono(samples_cn, sr), sr, window_s, hop_s)
    return -0.691 + 10.0 * torch.log10(ms + 1e-20)


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    return torch.quantile(x, q / 100.0, dim=-1, interpolation="linear")


def _masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Percentile of ``x[mask]`` along the last axis with linear
    interpolation (the masked values sort to the end)."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, big)), dim=-1).values
    n = mask.sum(-1)
    pos = (q / 100.0) * (n.to(x.dtype) - 1.0)
    lo = torch.clamp(torch.floor(pos).long(), 0, x.shape[-1] - 1)
    hi = torch.minimum(torch.clamp(lo + 1, min=0), torch.clamp(n - 1, min=0))
    frac = pos - lo.to(x.dtype)
    return (xs.gather(-1, lo[..., None])[..., 0] * (1.0 - frac)
            + xs.gather(-1, hi[..., None])[..., 0] * frac)


def lra_short_term(samples_cn: torch.Tensor, sr: int) -> torch.Tensor:
    """Loudness range of the short-term series: values at or below
    ``p10 - 20`` are dropped (all kept if none survives), then p95 - p10."""
    st = lufs_series(samples_cn, sr, 3.0, 1.0)
    mask = st > (_percentile(st, 10.0) - 20.0)[..., None]
    m = torch.where(mask.any(-1, keepdim=True), mask, torch.ones_like(mask))
    return _masked_percentile(st, m, 95.0) - _masked_percentile(st, m, 10.0)


def true_peak_dbfs(samples_cn: torch.Tensor, sr: int, oversample: int = 4) -> torch.Tensor:
    """Oversampled peak of the channel mean, dBFS."""
    y = _oversample(samples_cn.float().mean(-2), int(oversample))
    return 20.0 * torch.log10(y.abs().amax(-1) + 1e-20)


def loudness_report(samples_cn: torch.Tensor, sr: int, compute_true_peak: bool = True,
                    oversample: int = 4) -> Dict[str, torch.Tensor]:
    """Every Loudness Meter reading (four K-weightings: integrated,
    momentary, short-term and LRA)."""
    out = {
        "lufs_integrated": integrated_lufs(samples_cn, sr),
        "lufs_momentary": lufs_series(samples_cn, sr, 0.400, 0.100).mean(-1),
        "lufs_short_term": lufs_series(samples_cn, sr, 3.0, 1.0).mean(-1),
        "lra": lra_short_term(samples_cn, sr),
    }
    if compute_true_peak:
        out["true_peak_dbfs"] = true_peak_dbfs(samples_cn, sr, oversample)
    return out
