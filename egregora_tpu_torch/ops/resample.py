"""Sample-rate conversion: Kaiser-windowed-sinc polyphase filtering as a
blocked Toeplitz matmul.

Counterpart of ``egregora_tpu/ops/resample.py`` (``resample``,
``resample_poly``, ``resample_linear``, ``resampled_length``,
``oversample``).  Output length is
``ceil(N * up / down)`` with output sample ``j`` at input time
``j * down / up`` (scipy ``resample_poly`` lengths).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .stft import device_tensor, frame_strided

DEFAULT_WIDTH = 64        # zero-crossings per side
DEFAULT_ROLLOFF = 0.945   # fraction of Nyquist retained
DEFAULT_BETA = 14.769     # Kaiser beta


@functools.lru_cache(maxsize=64)
def _design_kernel(up: int, down: int, width: int, rolloff: float, beta: float) -> np.ndarray:
    """Kaiser-windowed sinc lowpass at the upsampled rate, gain ``up``.

    Cutoff in cycles per upsampled sample: ``rolloff * min(1, up/down) /
    (2*up)``, i.e. ``rolloff`` of the lower Nyquist."""
    w_c = rolloff * min(1.0, up / down) / (2.0 * up)
    half = int(math.ceil(width / (2.0 * w_c)))
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = 2.0 * w_c * np.sinc(2.0 * w_c * n)
    h *= np.kaiser(2 * half + 1, beta)
    h /= h.sum()          # unit DC gain at the upsampled rate
    h *= up               # compensate zero-stuffing energy loss
    return h.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _block_matrix(up: int, down: int, width: int, rolloff: float, beta: float):
    """(M [L+2m, Bout], L, Bout, m): one dense matrix maps every padded
    input block ``[b*L - m, b*L + L + m)`` to its ``Bout`` outputs
    (``L`` a multiple of ``down``, so ``L*up == Bout*down``)."""
    h = _design_kernel(up, down, width, rolloff, beta)
    half = (h.shape[0] - 1) // 2
    m = half // up + 1                       # input-sample halo
    l = down * max(1, -(-512 // down))
    bout = l * up // down
    rows = l + 2 * m
    mat = np.zeros((rows, bout), dtype=np.float32)
    idx_i = np.arange(rows)[:, None] - m
    idx_j = np.arange(bout)[None, :]
    t = idx_i * up - idx_j * down + half     # tap index into h
    valid = (t >= 0) & (t < h.shape[0])
    mat[valid] = h[t[valid]]
    return mat, l, bout, m


def _block_matrix_only(up: int, down: int, width: int, rolloff: float,
                       beta: float) -> np.ndarray:
    return _block_matrix(up, down, width, rolloff, beta)[0]


def resampled_length(n: int, src_sr: int, dst_sr: int) -> int:
    """Output length of ``resample_poly`` for an ``n``-sample input."""
    if int(src_sr) == int(dst_sr):
        return int(n)
    g = math.gcd(int(src_sr), int(dst_sr))
    up, down = dst_sr // g, src_sr // g
    return -(-int(n) * up // down)


def resample_poly(x_cs: torch.Tensor, src_sr: int, dst_sr: int, *,
                  width: int = DEFAULT_WIDTH, rolloff: float = DEFAULT_ROLLOFF,
                  beta: float = DEFAULT_BETA) -> torch.Tensor:
    """Polyphase resample ``[C, S] -> [C, ceil(S*up/down)]``."""
    src_sr, dst_sr = int(src_sr), int(dst_sr)
    x = x_cs.float()
    if src_sr == dst_sr:
        return x
    g = math.gcd(src_sr, dst_sr)
    up, down = dst_sr // g, src_sr // g
    _, l, bout, m = _block_matrix(up, down, width, rolloff, beta)
    mat = device_tensor(_block_matrix_only, up, down, width, rolloff, beta,
                        device=str(x.device))
    c, s = x.shape
    out_len = -(-s * up // down)
    nb = -(-s // l)
    xp = F.pad(x, (m, m + nb * l - s))
    frames = frame_strided(xp, l + 2 * m, l)[:, :nb]      # [C, nb, L+2m]
    return (frames @ mat).reshape(c, nb * bout)[:, :out_len]


def resample_linear(x_cs: torch.Tensor, src_sr: int, dst_sr: int) -> torch.Tensor:
    """Linear-interpolation resample: both time grids are float32
    ``linspace(0, 1, N, endpoint=False)``; outputs past the last input
    sample hold its value (``np.interp`` semantics)."""
    src_sr, dst_sr = int(src_sr), int(dst_sr)
    x = x_cs.float()
    if src_sr == dst_sr:
        return x
    s = x.shape[-1]
    n_out = int(round(s * dst_sr / float(src_sr)))
    dev = x.device
    t_in = torch.arange(s, dtype=torch.float32, device=dev) * np.float32(1.0 / s)
    t_out = torch.arange(n_out, dtype=torch.float32, device=dev) * np.float32(1.0 / n_out)
    i = torch.clamp(torch.searchsorted(t_in, t_out, right=True), 1, s - 1)
    delta = t_out - t_in[i - 1]
    y = x[:, i - 1] + (delta / (t_in[i] - t_in[i - 1])) * (x[:, i] - x[:, i - 1])
    return torch.where(t_out > t_in[-1], x[:, -1:], y)


def resample(x_cs: torch.Tensor, src_sr: int, dst_sr: int, *,
             mode: str = "auto", width: int = DEFAULT_WIDTH,
             rolloff: float = DEFAULT_ROLLOFF, beta: float = DEFAULT_BETA) -> torch.Tensor:
    """HQ resample: "auto", "scipy_polyphase" and "torchaudio" (the
    reference's vocabulary) all map to the polyphase filter; "linear"
    keeps the cheap path."""
    if mode == "linear":
        return resample_linear(x_cs, src_sr, dst_sr)
    return resample_poly(x_cs, src_sr, dst_sr, width=width, rolloff=rolloff, beta=beta)


def oversample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer oversampling along the last axis of ``[..., N]`` (true
    peak): ``resample_poly`` with scipy.signal.resample_poly's default
    design (Kaiser beta 5.0, 10 zero crossings a side, cutoff at the
    input's Nyquist)."""
    x = x.float()
    if factor <= 1:
        return x
    y = resample_poly(x.reshape(-1, x.shape[-1]), 1, int(factor), width=10,
                      rolloff=1.0, beta=5.0)
    return y.reshape(x.shape[:-1] + (y.shape[-1],))
