"""WPE (weighted prediction error) dereverberation, batched over frequency.

Counterpart of ``egregora_tpu/models/wpe.py``.  Given the STFT ``Y [F, C,
T]`` (F bins, C mics, T frames), ``taps`` K, ``delay`` D and
``iterations``:

    Z = Y
    repeat:
      lambda[t] = mean_c |Z[:, c, t]|^2, floored at 1e-4 of its max per bin
      Ytil[t]   = Y[t-D], ..., Y[t-D-K+1] stacked           [F, C*K, T]
      R = Ytil diag(1/lambda) Ytil^H + Tikhonov (1e-4 of mean diag)
      P = Ytil diag(1/lambda) Y^H
      G = solve(R, P)                                       [F, C*K, C]
      Z = Y - G^H Ytil

every bin at once: one batched complex ``torch.linalg.solve`` over the F
bins an iteration (the JAX package solves the same systems with
``jnp.linalg.solve`` under ``vmap``).  ``wpe_dereverb`` wraps it in the
port's periodic-Hann STFT pair (``ops.stft``) with ``n_fft`` of zero
padding at both ends.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.stft import istft, stft


def _stack_taps(y_fct: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """``[F, C, T] -> [F, C*taps, T]`` delayed tap stack (zero history)."""
    t = y_fct.shape[-1]
    return torch.cat([F.pad(y_fct, (delay + k, 0))[..., :t] for k in range(taps)], 1)


def wpe(y_fct: torch.Tensor, taps: int = 10, delay: int = 3, iterations: int = 3,
        eps: float = 1e-8) -> torch.Tensor:
    """Dereverberate a complex STFT ``[F, C, T]`` -> same shape."""
    ytil = _stack_taps(y_fct, taps, delay)                    # [F, CK, T]
    ytil_h = ytil.conj().transpose(-1, -2)                    # [F, T, CK]
    y_h = y_fct.conj().transpose(-1, -2)                      # [F, T, C]
    ck = ytil.shape[1]
    eye = torch.eye(ck, dtype=y_fct.dtype, device=y_fct.device)
    z = y_fct
    for _ in range(int(iterations)):
        lam = z.abs().square().mean(1)                        # [F, T]
        lam = torch.maximum(lam, 1e-4 * lam.amax(-1, keepdim=True) + 1e-12)
        ytw = ytil * (1.0 / lam)[:, None, :]
        r = ytw @ ytil_h                                      # [F, CK, CK]
        p = ytw @ y_h                                         # [F, CK, C]
        tr = torch.diagonal(r, dim1=-2, dim2=-1).real.sum(-1) / ck
        r = r + (1e-4 * tr + 1e-10)[:, None, None] * eye
        g = torch.linalg.solve(r, p)                          # [F, CK, C]
        z = y_fct - g.conj().transpose(-1, -2) @ ytil
    return z


def wpe_dereverb(x_cn: torch.Tensor, taps: int = 10, delay: int = 3,
                 iterations: int = 3, n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Waveform in, waveform out: STFT -> ``wpe`` -> inverse STFT, for a
    mic array ``[C, N]`` -> ``[C, N]`` float32."""
    n = x_cn.shape[-1]
    xp = F.pad(x_cn.float(), (n_fft, n_fft))
    spec = stft(xp, n_fft, hop, window="hann_periodic")      # [C, frames, bins]
    z = wpe(spec.permute(2, 0, 1), taps=taps, delay=delay, iterations=iterations)
    out = istft(z.permute(1, 2, 0), n_fft, hop, n + 2 * n_fft)
    return out[:, n_fft: n_fft + n]
