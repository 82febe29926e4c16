"""Audio file reading at the host edge.

Counterpart of ``egregora_tpu/utils/wavio.py``'s ``read_audio``, with its
backend order: the native codec (``utils.native``) for WAV and FLAC,
then ``soundfile`` where it is installed (any format), then the stdlib
``wave`` module (PCM 8/16/24/32-bit WAV).
"""
from __future__ import annotations

import importlib.util
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def _pcm_to_float(raw: bytes, width: int) -> np.ndarray:
    if width == 2:
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        return np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    if width == 1:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"unsupported WAV sample width {width}")


def read_audio(path: PathLike) -> Tuple[np.ndarray, int]:
    """An audio file -> (``[C, S]`` float32 in [-1, 1], sr)."""
    path = str(path)
    lower = path.lower()
    if lower.endswith((".wav", ".flac")):
        from . import native
        try:
            return native.read_wav(path) if lower.endswith(".wav") else native.read_flac(path)
        except RuntimeError:
            pass
    if importlib.util.find_spec("soundfile") is not None:
        import soundfile as sf
        data, sr = sf.read(path, dtype="float32", always_2d=True)   # [S, C]
        return np.ascontiguousarray(data.T), int(sr)
    with wave.open(path, "rb") as w:
        sr, ch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    x = _pcm_to_float(raw, width)
    return np.ascontiguousarray(x.reshape(-1, ch).T), int(sr)
