"""Mel-spectrogram front-end of the FlashSR stack.

Counterpart of ``egregora_tpu/models/flashsr/mel.py``: 48 kHz, n_fft
2048, hop 480 (100 frames/s), 256 Slaney-scale mel bands with area
normalisation, natural-log compression ``log(clip(mel, 1e-5))``; plus
the envelope projection (``envelope_gain``, ``mel_envelope_match``)
that re-imposes a predicted mel envelope on a waveform's STFT.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.stft import device_tensor, istft_dense, stft_conv

SAMPLE_RATE = 48000
N_FFT = 2048
HOP = 480
N_MELS = 256
FMIN = 20.0
FMAX = 24000.0


def _hz_to_mel(f: np.ndarray, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_mel = 1000.0 / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, 1000.0 * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT, n_mels: int = N_MELS,
                   fmin: float = FMIN, fmax: float = FMAX, htk: bool = False,
                   norm: bool = True) -> np.ndarray:
    """Triangular mel filterbank ``[n_fft//2+1, n_mels]`` (librosa-compatible)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin), htk), _hz_to_mel(np.array(fmax), htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_freqs, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    if norm:  # Slaney area normalisation
        fb *= (2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_band_peaks(sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   n_mels: int = N_MELS, fmin: float = FMIN,
                   fmax: float = FMAX) -> np.ndarray:
    """``[n_mels]`` triangle-peak frequencies (Hz) of the filterbank."""
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)),
                          n_mels + 2)
    return _mel_to_hz(mel_pts)[1: n_mels + 1].astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_unmix(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """``[n_mels, n_fft//2+1]``: column-normalised filterbank transpose,
    mapping a per-band log-gain to a smooth per-bin log-gain."""
    fb = mel_filterbank(sr, n_fft, n_mels)
    cover = np.maximum(fb.sum(axis=1, keepdims=True), 1e-10)
    return (fb / cover).T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _frame_interp(frames_out: int, hop_out: int, frames_in: int,
                  hop_in: int) -> np.ndarray:
    """``[frames_out, frames_in]`` linear time interpolation between two
    centre-aligned frame grids."""
    pos = np.clip(np.arange(frames_out) * (hop_out / hop_in), 0.0, frames_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, frames_in - 1)
    w = (pos - lo).astype(np.float32)
    m = np.zeros((frames_out, frames_in), np.float32)
    m[np.arange(frames_out), lo] += 1.0 - w
    m[np.arange(frames_out), hi] += w
    return m


@functools.lru_cache(maxsize=8)
def _log_band_weight(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    return np.log(np.maximum(mel_filterbank(sr, n_fft, n_mels).sum(axis=0), 1e-10),
                  dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _covered_bins(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    return mel_filterbank(sr, n_fft, n_mels).sum(axis=1) > 0


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of ``[..., T]``."""
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(
        lead + (x.shape[-1] + 2 * pad,))


def envelope_gain(re: torch.Tensor, im: torch.Tensor, log_mel_tgt: torch.Tensor,
                  sr: int = SAMPLE_RATE, n_fft: int = N_FFT, hop: int = 512,
                  max_log_gain: float = 2.5, replace: bool = False) -> torch.Tensor:
    """Per-bin magnitude gain ``[..., frames, n_fft//2+1]`` projecting an
    STFT onto a predicted log-mel envelope: per-band log ratio of target
    to current mel, interpolated over frames and bins, clamped to
    ``max_log_gain`` nats.  ``replace=True`` returns the gain that makes
    the magnitude the smooth mel-implied envelope itself."""
    mel_frames, n_mels = log_mel_tgt.shape[-2:]
    dev = str(re.device)
    mag = torch.sqrt(re * re + im * im + 1e-20)
    ti = device_tensor(_frame_interp, re.shape[-2], hop, mel_frames, HOP, device=dev)
    tgt = torch.einsum("fj,...jm->...fm", ti, log_mel_tgt.float())
    unmix = device_tensor(_mel_unmix, sr, n_fft, n_mels, device=dev)
    if replace:
        env_log = (tgt - device_tensor(_log_band_weight, sr, n_fft, n_mels, device=dev)) @ unmix
        dlog_bin = torch.clamp(env_log - torch.log(torch.clamp(mag, min=1e-5)),
                               -max_log_gain, max_log_gain)
        covered = device_tensor(_covered_bins, sr, n_fft, n_mels, device=dev)
        return torch.where(covered, torch.exp(dlog_bin), torch.ones_like(dlog_bin))
    fb = device_tensor(mel_filterbank, sr, n_fft, n_mels, device=dev)
    cur = torch.log(torch.clamp(mag @ fb, min=1e-5))
    dlog = torch.clamp(tgt - cur, -max_log_gain, max_log_gain)
    return torch.exp(dlog @ unmix)


def mel_envelope_match(wav: torch.Tensor, log_mel_tgt: torch.Tensor,
                       sr: int = SAMPLE_RATE, n_fft: int = N_FFT, hop: int = 512,
                       max_log_gain: float = 2.5, replace: bool = False) -> torch.Tensor:
    """Re-impose a predicted log-mel envelope on a waveform's STFT
    magnitude: ``[..., T], [..., mel_frames, n_mels] -> [..., T]``."""
    t = wav.shape[-1]
    pad = n_fft // 2
    re, im = stft_conv(_reflect_pad(wav.float(), pad), n_fft, hop)
    gain = envelope_gain(re, im, log_mel_tgt, sr=sr, n_fft=n_fft, hop=hop,
                         max_log_gain=max_log_gain, replace=replace)
    return istft_dense(re * gain, im * gain, n_fft, hop)[..., pad: pad + t]


def log_mel(x: torch.Tensor, sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
            hop: int = HOP, n_mels: int = N_MELS) -> torch.Tensor:
    """``[..., T] -> [..., T // hop + 1, n_mels]`` natural-log mel
    spectrogram of the reflect-centred signal."""
    re, im = stft_conv(_reflect_pad(x.float(), n_fft // 2), n_fft, hop)
    mag = torch.sqrt(re * re + im * im + 1e-20)
    mel = mag @ device_tensor(mel_filterbank, sr, n_fft, n_mels, device=str(x.device))
    return torch.log(torch.clamp(mel, min=1e-5))
