"""First-order IIR filters: the K-weighting front-end, a biquad as two
first-order sections, and the VAD smoother.

Counterpart of ``egregora_tpu/ops/iir.py``.  The recurrences run in
float32 along the last axis:

* ``first_order_lowpass`` and ``k_weight``'s low-pass are ``z[n] =
  (1-k) x[n] + k z[n-1]``; on a CUDA tensor ``k_weight`` runs the
  hand-written kernel (``ops.iir_lowpass``, K4), on a CPU tensor its
  plain version;
* ``_first_order_recurrence`` (``y[n] = f[n] + p y[n-1]``) is blocked:
  within a block of 1024 samples the recurrence runs step by step for
  every block at once, and the blocks' end states are the same
  recurrence with pole ``p^1024``, solved the same way and added back
  with pole powers computed in float64.  A single float32 scan over a
  whole signal loses ~4e-2 for poles within 1e-3 of 1; blocking bounds
  the error to what one block accumulates.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _first_order_recurrence(f: torch.Tensor, p: float, block: int = 1024) -> torch.Tensor:
    """``y[n] = f[n] + p y[n-1]``, y[-1] = 0, along the last axis (float32)."""
    f = f.float()
    t = f.shape[-1]
    block = max(1, min(block, t))
    nb = -(-t // block)
    fb = F.pad(f, (0, nb * block - t)).reshape(f.shape[:-1] + (nb, block))
    p32 = float(np.float32(p))
    y = torch.empty_like(fb)
    s = torch.zeros(fb.shape[:-1], dtype=torch.float32, device=f.device)
    for i in range(block):
        s = fb[..., i] + p32 * s
        y[..., i] = s
    if nb > 1:
        # state entering block b: the blocks' end states scanned with pole p^block
        states = _first_order_recurrence(y[..., -1], float(p) ** block, block)
        entering = F.pad(states[..., :-1], (1, 0))
        with np.errstate(under="ignore"):
            pows = np.power(float(p), np.arange(1, block + 1, dtype=np.float64))
        y = y + torch.from_numpy(pows.astype(np.float32)).to(f.device) * entering[..., None]
    return y.reshape(f.shape[:-1] + (nb * block,))[..., :t]


def first_order_lowpass(x: torch.Tensor, k: float) -> torch.Tensor:
    """``z[n] = (1-k) x[n] + k z[n-1]`` along the last axis, z[-1] = 0."""
    return _first_order_recurrence(float(np.float32(1.0 - k)) * x.float(), k)


def k_weight(sr: int, x_cn: torch.Tensor) -> torch.Tensor:
    """K-weighting approximation of the reference meter: a first-order
    ~60 Hz high-pass (x minus its low-pass) plus a 0.02 first-difference
    HF tilt, on ``[..., N]``.  The low-pass runs on ``[rows, N]`` in one
    call: the K4 kernel for a CUDA tensor, its plain version for a CPU
    one."""
    from .iir_lowpass import iir_lowpass
    fc = 60.0 / (sr * 0.5)
    k = math.exp(-2.0 * math.pi * fc)
    x = x_cn.float()
    z = iir_lowpass(x.reshape(-1, x.shape[-1]).contiguous(), k).reshape(x.shape)
    y = x - z
    tilt = y.clone()
    tilt[..., 1:] += 0.02 * (y[..., 1:] - y[..., :-1])
    return tilt


def biquad(x: torch.Tensor, b: tuple, a: tuple) -> torch.Tensor:
    """Direct-form biquad along the last axis, zero initial state:
    ``y[n] = x[n] + b0 x[n-1] + b1 x[n-2] - a0 y[n-1] - a1 y[n-2]``
    (RNNoise's convention).  The numerator is applied exactly as a FIR;
    the denominator must have real poles, and runs as two blocked
    first-order sections."""
    roots = np.roots([1.0, float(a[0]), float(a[1])])
    if np.iscomplexobj(roots) and np.abs(roots.imag).max() > 1e-9:
        raise ValueError("biquad: complex poles not supported (use two calls)")
    p1, p2 = (float(r.real) for r in roots)
    x = x.float()
    xm1 = F.pad(x[..., :-1], (1, 0))
    xm2 = F.pad(x[..., :-2], (2, 0))
    f = x + float(np.float32(b[0])) * xm1 + float(np.float32(b[1])) * xm2
    return _first_order_recurrence(_first_order_recurrence(f, p1), p2)


def ema_smooth(probs: torch.Tensor, smooth_ms: float, hop_ms: float = 10.0) -> torch.Tensor:
    """Exponential smoothing of per-frame probabilities, seeded with
    ``probs[0]``: ``acc = alpha*acc + (1-alpha)*p`` per frame (the
    reference VAD smoother)."""
    if smooth_ms <= 0:
        return probs
    alpha = math.exp(-hop_ms / max(1e-3, float(smooth_ms)))
    p = probs.float()
    b = float(np.float32(1.0 - alpha)) * p
    b = torch.cat([b[..., :1] + float(np.float32(alpha)) * p[..., :1], b[..., 1:]], dim=-1)
    return _first_order_recurrence(b, alpha)
