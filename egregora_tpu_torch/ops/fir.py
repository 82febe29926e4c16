"""FIR filtering as overlap-save Toeplitz matmuls.

Counterpart of ``egregora_tpu/ops/fir.py::fir_same``: the filter becomes
a dense banded-Toeplitz ``[block+taps-1, block]`` matrix applied to
strided frames, one float32 matmul for the whole signal.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .stft import device_tensor, frame_strided

BLOCK = 1792  # output samples per frame


@contextlib.contextmanager
def exact_f32():
    """float32 convolutions and matmuls on the card in full float32, not
    TF32, whatever the global flags say (cuDNN's default is TF32, which
    keeps about three digits); the flags are restored on exit."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = prev


@functools.lru_cache(maxsize=16)
def _toeplitz(h_bytes: bytes, taps: int, block: int) -> np.ndarray:
    """``M[t, j] = h[t - j]`` for ``0 <= t - j < taps`` — [block+taps-1, block]."""
    h = np.frombuffer(h_bytes, dtype=np.float32)
    m = np.zeros((block + taps - 1, block), dtype=np.float32)
    for k in range(taps):
        m[np.arange(block) + k, np.arange(block)] = h[k]
    return m


def fir_same(x: torch.Tensor, h: np.ndarray, block: int = BLOCK) -> torch.Tensor:
    """'same'-mode FIR along the last axis, centred like ``np.convolve``,
    with zero-padded boundaries.  ``h`` is a host float32 array."""
    h = np.asarray(h, dtype=np.float32)
    taps = h.shape[0]
    # np.convolve flips the kernel; the Toeplitz implements correlation
    c = taps - 1 - (taps - 1) // 2
    h = h[::-1].copy()
    t = x.shape[-1]
    n_blocks = -(-t // block)
    xp = F.pad(x.float(), (c, n_blocks * block + (taps - 1 - c) - t))
    frames = frame_strided(xp, block + taps - 1, block)   # [..., n_blocks, L]
    m = device_tensor(_toeplitz, h.tobytes(), taps, block, device=str(x.device))
    y = frames @ m                                        # [..., n_blocks, block]
    return y.reshape(x.shape[:-1] + (n_blocks * block,))[..., :t]
