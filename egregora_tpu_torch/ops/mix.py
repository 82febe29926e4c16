"""Adaptive VAD-driven wet/dry mixing of the denoiser nodes.

Counterpart of ``egregora_tpu/ops/mix.py``, on tensors of any device:

* VAD smoothing: 10 ms-frame EMA with ``alpha = exp(-10/smooth_ms)``
  seeded at probs[0] (``ops.iir.ema_smooth``);
* strength per frame: off / more_on_noise / more_on_speech /
  gate_on_noise;
* gains: equal-power (sin/cos) or linear crossfade;
* per-frame strengths expand to per-sample by a ``frame_hop`` repeat.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .iir import ema_smooth


def strength_per_frame(base_s: float, vad_smooth: torch.Tensor, adaptive_mode: str,
                       adaptive_amount: float, vad_threshold: float) -> torch.Tensor:
    s0 = float(np.float32(base_s))
    a = float(np.float32(adaptive_amount))
    v = vad_smooth.float().clamp(0.0, 1.0)
    if adaptive_mode == "more_on_noise":
        s_eff = s0 + a * (1.0 - v) * (1.0 - s0)
    elif adaptive_mode == "more_on_speech":
        s_eff = s0 + a * v * (1.0 - s0)
    elif adaptive_mode == "gate_on_noise":
        f32 = np.float32          # the JAX package's float32 scalar arithmetic
        s_noise = float(f32(s0) + f32(a) * (f32(1.0) - f32(s0)))
        s_speech = float(f32(s0) * (f32(1.0) - f32(a)))
        s_eff = torch.where(v < vad_threshold, torch.full_like(v, s_noise),
                            torch.full_like(v, s_speech))
    else:  # "off" or unknown
        s_eff = torch.full_like(v, s0)
    return s_eff.clamp(0.0, 1.0)


def gains_from_strength(s_eff: torch.Tensor, curve: str) -> Tuple[torch.Tensor, torch.Tensor]:
    s = s_eff.float().clamp(0.0, 1.0)
    if curve == "equal_power":
        half_pi = float(np.float32(0.5 * math.pi))
        return torch.cos(half_pi * s), torch.sin(half_pi * s)
    return 1.0 - s, s


def rms_vad_probs(x48: torch.Tensor, hop: int = 480) -> torch.Tensor:
    """Energy-proxy VAD on ``hop``-sample frames, p95-normalised; the
    ragged tail frame (ceil division) is its true-length mean square."""
    n = x48.shape[-1]
    n_frames = -(-n // hop)
    pad = n_frames * hop - n
    fr = F.pad(x48.float(), (0, pad)).reshape(x48.shape[:-1] + (n_frames, hop))
    ms = fr.square().mean(-1)
    if pad:
        ms[..., -1] *= hop / float(hop - pad)
    rms = torch.sqrt(ms)
    p95 = torch.quantile(rms, 0.95)
    p95 = torch.where(p95 <= 0.0, torch.full_like(p95, 1e-6), p95)
    return (rms / p95).clamp(0.0, 1.0)


def adaptive_mix(dry: torch.Tensor, wet: torch.Tensor, vad_probs: Optional[torch.Tensor], *,
                 strength: float, mix_curve: str, adaptive_mode: str,
                 adaptive_amount: float, vad_threshold: float, vad_smooth_ms: float,
                 frame_hop: int = 480) -> torch.Tensor:
    """Blend dry/wet 1-D signals with per-sample adaptive gains;
    ``vad_probs`` per frame, None for a constant ``strength``."""
    n = dry.shape[-1]
    if vad_probs is None:
        s_per = torch.full((n,), float(np.float32(strength)), device=dry.device)
    else:
        v = ema_smooth(vad_probs, vad_smooth_ms)
        s_eff = strength_per_frame(strength, v, adaptive_mode, adaptive_amount, vad_threshold)
        s_per = torch.repeat_interleave(s_eff, frame_hop)[:n]
        if s_per.shape[0] < n:
            s_per = F.pad(s_per, (0, n - s_per.shape[0]), value=float(np.float32(strength)))
    g_dry, g_wet = gains_from_strength(s_per, mix_curve)
    return (g_dry * dry + g_wet * wet).clamp(-1.0, 1.0)


def post_gain_limit(y: torch.Tensor, post_gain_db: float, limit_ceiling: bool,
                    ceiling: float) -> torch.Tensor:
    """Post-gain, peak-ceiling limiter, clamp to [-1, 1]."""
    if post_gain_db != 0.0:
        y = y * float(np.float32(10.0 ** (post_gain_db / 20.0)))
    if limit_ceiling:
        peak = y.abs().max()
        c = float(np.float32(ceiling))
        y = y * torch.where((peak > c) & (peak > 0), c / peak, torch.ones_like(peak))
    return y.clamp(-1.0, 1.0)
