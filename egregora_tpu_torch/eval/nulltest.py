"""Gain match and null test.

Counterpart of ``egregora_tpu/eval/nulltest.py`` (the reference's
``Audio_Gain_Match.execute`` and ``Audio_Null_Test.execute``): the
compute cores; the node layer coerces, resamples and, for "Null Test
(Full)", composes them with the alignment.  Signals are ``[..., C, N]``
(leading axes a batch of pairs), same rate and length.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.stft import stft_mag
from .loudness import integrated_lufs, rms_db
from .metrics import band_energy_hi_db, corr_coef, lsd


def gain_match(ref_cn: torch.Tensor, in_cn: torch.Tensor, sr: int, mode: str = "LUFS-I",
               max_gain_db: float = 12.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match ``in``'s level to ``ref``'s by LUFS-I (two K-weightings) or
    RMS, the gain clamped to +-|max_gain_db|.  Returns (matched, gain_db,
    ref_level, in_level)."""
    if str(mode).upper().startswith("LUFS"):
        ref_level = integrated_lufs(ref_cn, sr)
        in_level = integrated_lufs(in_cn, sr)
    else:
        ref_level = rms_db(ref_cn.float().mean(-2), dim=-1)
        in_level = rms_db(in_cn.float().mean(-2), dim=-1)
    lim = abs(float(max_gain_db))
    gain_db = torch.clamp(ref_level - in_level, -lim, lim)
    gain = torch.pow(10.0, gain_db / 20.0)
    return in_cn.float() * gain[..., None, None], gain_db, ref_level, in_level


def null_test(a_cn: torch.Tensor, b_cn: torch.Tensor, sr: int, *, invert_b: bool = True,
              least_squares_scale: bool = False, compute_corr: bool = True,
              compute_null_rms: bool = True, compute_null_lufs: bool = True,
              compute_lsd: bool = True, compute_hf_residual: bool = False,
              n_fft: int = 2048, hop: int = 512, hf_band_hz: int = 8000
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Null = A + (-B), B optionally scaled by the least-squares ``k =
    <a,b>/<b,b>`` of the channel means, with the reference's metrics."""
    a_cn, b_cn = a_cn.float(), b_cn.float()
    k = torch.ones(a_cn.shape[:-2], dtype=torch.float32, device=a_cn.device)
    if least_squares_scale:
        a_m, b_m = a_cn.mean(-2), b_cn.mean(-2)
        k = (a_m * b_m).sum(-1) / ((b_m * b_m).sum(-1) + 1e-20)
        b_cn = b_cn * k[..., None, None]
    b_signed = -b_cn if invert_b else b_cn
    null = a_cn + b_signed
    a_m = a_cn.mean(-2)
    b_m = (-b_signed).mean(-2)

    metrics: Dict[str, torch.Tensor] = {}
    if compute_corr:
        metrics["corr_coef"] = corr_coef(a_m, b_m)
    if compute_null_rms:
        metrics["null_rms_dbfs"] = rms_db(null.mean(-2), dim=-1)
    if compute_null_lufs:
        metrics["null_lufs"] = integrated_lufs(null, sr)
    if compute_lsd:
        m, p95 = lsd(stft_mag(a_m, n_fft, hop), stft_mag(b_m, n_fft, hop))
        metrics["lsd_mean_db"] = m
        metrics["lsd_p95_db"] = p95
    if compute_hf_residual:
        metrics["hf_residual_db"] = band_energy_hi_db(null, sr, float(hf_band_hz))
    overs = (null.abs() > 1.0).sum((-2, -1))
    metrics["overshoot_count"] = overs
    metrics["clipped_pct"] = 100.0 * overs / (null.shape[-2] * null.shape[-1])
    metrics["scale_k"] = k
    return null, metrics
