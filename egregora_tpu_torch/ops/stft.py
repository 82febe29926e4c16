"""STFT pieces: windows, framing, the complex STFT and its WOLA inverse
(the eval path), the windowed-DFT analysis matmul and the dense inverse
with its overlap-add floor (the FlashSR path).

Counterpart of ``egregora_tpu/ops/stft.py``.  Framing follows the
reference meter: ``frames = 1 + max(0, (N - n_fft) // hop)``, no
centring, the tail that does not fill a frame dropped, a signal shorter
than one frame zero-padded.  ``stft`` windows with the symmetric Hann
(``np.hanning``) unless asked for the periodic one and transforms with
``torch.fft.rfft``.  The DFT bases of ``stft_conv``/``istft_dense`` are
built in numpy with float32 angles, as the JAX package builds them, and
cached per device.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import count


@functools.lru_cache(maxsize=32)
def hann_symmetric(n: int) -> np.ndarray:
    """``np.hanning``-style symmetric Hann window (zeros at both ends)."""
    return np.hanning(n).astype(np.float32)


@functools.lru_cache(maxsize=32)
def hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann (DFT-even) — perfect-reconstruction WOLA window."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


def _window(n_fft: int, window: str) -> np.ndarray:
    return hann_periodic(n_fft) if window == "hann_periodic" else hann_symmetric(n_fft)


@functools.lru_cache(maxsize=32)
def device_tensor(array_fn, *args, device: str = "cpu") -> torch.Tensor:
    """``torch.from_numpy(array_fn(*args))`` on ``device``, cached: the
    constant matrices of the DSP ops are made once per device.  Made
    outside inference mode, so that a constant first made by an inference
    call can still be saved for a training step's backward.  Each build
    (a miss) is counted as ``const_builds``."""
    count("const_builds")
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(array_fn(*args))).to(device)


def num_frames(n: int, n_fft: int, hop: int) -> int:
    return 1 + max(0, (n - n_fft) // hop)


def frame_strided(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``[..., T] -> [..., frames, n_fft]`` with ``frames = 1 +
    max(0, (T - n_fft)//hop)``; the tail that does not fill a frame is
    dropped, and a signal shorter than one frame is zero-padded."""
    if x.shape[-1] < n_fft:
        x = F.pad(x, (0, n_fft - x.shape[-1]))
    return x.unfold(-1, n_fft, hop)


frame = frame_strided


def stft(x: torch.Tensor, n_fft: int = 2048, hop: int = 512, *,
         window: str = "hann") -> torch.Tensor:
    """Complex STFT ``[..., N] -> [..., frames, n_fft//2+1]``."""
    w = device_tensor(_window, n_fft, window, device=str(x.device))
    return torch.fft.rfft(frame(x.float(), n_fft, hop) * w, dim=-1)


def stft_mag(x: torch.Tensor, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """Magnitude STFT in the reference meter's orientation ``[..., freqs,
    frames]`` (symmetric Hann, tail-drop framing)."""
    return stft(x, n_fft, hop, window="hann").abs().transpose(-1, -2)


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int, *,
          window: str = "hann_periodic") -> torch.Tensor:
    """WOLA inverse STFT ``[..., frames, n_fft//2+1] -> [..., length]``:
    synthesis window = analysis window, squared-window overlap-add
    normalisation.  Where the window coverage is below 1e-3 of its peak
    (the signal's edges) the output is 0 rather than amplified."""
    dev = str(spec.device)
    w = device_tensor(_window, n_fft, window, device=dev)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w          # [..., F, n_fft]
    f = frames.shape[-2]
    total = (f - 1) * hop + n_fft
    pos = (torch.arange(f, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    lead = frames.shape[:-2]
    acc = frames.new_zeros(lead + (total,)).index_add_(-1, pos, frames.reshape(lead + (-1,)))
    wsum = w.new_zeros(total).index_add_(0, pos, (w * w).repeat(f))
    floor = 1e-3 * wsum.max()
    keep = wsum >= floor
    out = acc * keep / torch.where(keep, wsum, torch.ones_like(wsum))
    if total >= length:
        return out[..., :length]
    return F.pad(out, (0, length - total))


def spectrogram_db(x: torch.Tensor, n_fft: int = 2048, hop: int = 512,
                   floor: float = 1e-9) -> torch.Tensor:
    """``20 log10(|STFT| + floor)`` in the reference plotter's convention."""
    return 20.0 * torch.log10(stft_mag(x, n_fft, hop) + floor)


def _dft_phase(rows: int, cols: int, modulus: int) -> np.ndarray:
    """``(iota_rows x iota_cols) mod modulus`` as float32: the exact
    phase index grid every DFT basis is built from."""
    r = np.arange(rows, dtype=np.int64)[:, None]
    c = np.arange(cols, dtype=np.int64)[None, :]
    return ((r * c) % modulus).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _analysis_basis(n_fft: int, window: str) -> np.ndarray:
    """``[n_fft, 2*(n_fft//2+1)]``: windowed cos | -sin DFT columns,
    rounded as the JAX package rounds them (float32 angles)."""
    nbins = n_fft // 2 + 1
    ang = _dft_phase(n_fft, nbins, n_fft) * np.float32(-2.0 * np.pi / n_fft)
    w = _window(n_fft, window)[:, None]
    return np.concatenate([np.cos(ang) * w, np.sin(ang) * w], axis=1)


@functools.lru_cache(maxsize=8)
def _synthesis_basis(n_fft: int, window: str) -> np.ndarray:
    """``[2*(n_fft//2+1), n_fft]`` such that ``[re | im] @ basis ==
    irfft(re + i*im) * window``."""
    nbins = n_fft // 2 + 1
    ang = _dft_phase(nbins, n_fft, n_fft) * np.float32(2.0 * np.pi / n_fft)
    ck = np.full((nbins, 1), 2.0 / n_fft, np.float32)
    ck[0, 0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        ck[-1, 0] = 1.0 / n_fft
    w = _window(n_fft, window)[None, :]
    return np.concatenate([np.cos(ang) * ck * w, -np.sin(ang) * ck * w], axis=0)


def stft_conv(x: torch.Tensor, n_fft: int, hop: int, *,
              window: str = "hann_periodic") -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT as framing + one windowed-DFT matmul: ``[..., T] -> (re, im)``
    each ``[..., frames, n_fft//2+1]``."""
    fr = frame_strided(x.float(), n_fft, hop)
    y = fr @ device_tensor(_analysis_basis, n_fft, window, device=str(x.device))
    nbins = n_fft // 2 + 1
    return y[..., :nbins], y[..., nbins:]


@functools.lru_cache(maxsize=64)
def _ola_wsum(n_fft: int, hop: int, frames: int, window: str) -> np.ndarray:
    """Squared-window overlap-add normalizer ``[(frames-1)*hop + n_fft]``."""
    w2 = _window(n_fft, window).astype(np.float64) ** 2
    ws = np.zeros((frames - 1) * hop + n_fft, np.float64)
    for f in range(frames):
        ws[f * hop: f * hop + n_fft] += w2
    return ws.astype(np.float32)


def istft_dense(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int, *,
                window: str = "hann_periodic") -> torch.Tensor:
    """Inverse STFT for integer overlap ratios (``n_fft % hop == 0``):
    ``[..., F, n_fft//2+1] -> [..., (F-1)*hop + n_fft]``, synthesis window
    applied and squared-window OLA normalisation.  Samples whose window
    coverage is below 1e-3 of the peak are zeroed instead of amplified."""
    if n_fft % hop:
        raise ValueError(f"istft_dense needs n_fft % hop == 0, got {n_fft}/{hop}")
    k_full = n_fft // hop
    dev = str(re.device)
    frames = torch.cat([re, im], dim=-1) @ device_tensor(
        _synthesis_basis, n_fft, window, device=dev)       # [..., F, n_fft]
    f = frames.shape[-2]
    sub = frames.reshape(frames.shape[:-1] + (k_full, hop))
    acc = frames.new_zeros(frames.shape[:-2] + (f - 1 + k_full, hop))
    for j in range(k_full):
        acc[..., j: j + f, :] += sub[..., :, j, :]
    y = acc.reshape(acc.shape[:-2] + (-1,))
    wsum_np = _ola_wsum(n_fft, hop, f, window)
    floor = 1e-3 * float(wsum_np.max())
    wsum = device_tensor(_ola_wsum, n_fft, hop, f, window, device=dev)
    keep = wsum >= floor
    return y * keep / torch.where(keep, wsum, torch.ones_like(wsum))
