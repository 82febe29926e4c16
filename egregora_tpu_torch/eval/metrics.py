"""Objective metrics: SI-SDR, log-spectral distance, correlation and the
high-band energy share.

Counterpart of ``egregora_tpu/eval/metrics.py`` (the reference meter's
``_si_sdr`` / ``_lsd`` / ``_stft_mag``).  Every function reduces the
last axis (and ``lsd`` the frequency axis before it), so leading axes are
a batch of pairs; metrics are on mono, length-matched signals, as the
node layer prepares them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..ops.stft import stft_mag


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def si_sdr(s: torch.Tensor, s_hat: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SDR in dB: ``alpha = <s_hat, s>/<s, s>``, SDR =
    10 log10(|alpha s|^2 / |s_hat - alpha s|^2)."""
    s, s_hat = s.float(), s_hat.float()
    alpha = _dot(s_hat, s) / (_dot(s, s) + 1e-20)
    target = alpha[..., None] * s
    noise = s_hat - target
    return 10.0 * torch.log10((_dot(target, target) + 1e-20) / (_dot(noise, noise) + 1e-20))


def lsd(mag_a: torch.Tensor, mag_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-spectral distance (mean, p95 over frames) of ``[..., freqs,
    frames]`` magnitude spectra."""
    eps = 1e-12
    d = torch.square(20.0 * torch.log10(mag_a + eps) - 20.0 * torch.log10(mag_b + eps))
    per = torch.sqrt(d.mean(-2) + 1e-12)
    return per.mean(-1), torch.quantile(per, 0.95, dim=-1, interpolation="linear")


def lsd_sisdr_report(a_mono: torch.Tensor, b_mono: torch.Tensor, n_fft: int = 2048,
                     hop: int = 512, compute_lsd: bool = True,
                     compute_si_sdr: bool = True) -> Dict[str, torch.Tensor]:
    """The Metrics node's readings: LSD mean and p95 (dB), SI-SDR (dB)."""
    out = {}
    if compute_lsd:
        m, p95 = lsd(stft_mag(a_mono, n_fft, hop), stft_mag(b_mono, n_fft, hop))
        out["lsd_mean_db"] = m
        out["lsd_p95_db"] = p95
    if compute_si_sdr:
        out["si_sdr_db"] = si_sdr(a_mono, b_mono)
    return out


def corr_coef(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Zero-mean correlation coefficient.  The norms are ``sqrt(<x, x>)``
    through the same sum as the dot product: PyTorch's float32 ``norm`` on
    the CPU drifts ~1e-5 relative over a minute of audio."""
    am = a - a.mean(-1, keepdim=True)
    bm = b - b.mean(-1, keepdim=True)
    return _dot(am, bm) / (torch.sqrt(_dot(am, am) * _dot(bm, bm)) + 1e-20)


def band_energy_hi_db(x_cn: torch.Tensor, sr: int, lo_hz: float) -> torch.Tensor:
    """Share of the channel mean's spectral energy at or above ``lo_hz``,
    in dB."""
    mono = x_cn.float().mean(-2)
    p = torch.fft.rfft(mono).abs().square()
    freqs = torch.fft.rfftfreq(mono.shape[-1], d=1.0 / sr, device=mono.device)
    e_hi = torch.where(freqs >= lo_hz, p, torch.zeros_like(p)).sum(-1)
    return 10.0 * torch.log10(e_hi / (p.sum(-1) + 1e-20) + 1e-20)
