"""Audio file reading and writing at the host edge.

Counterpart of ``egregora_tpu/utils/wavio.py``, with its backend order:
the native codec (``utils.native``) for WAV and FLAC, then ``soundfile``
where it is installed (any format), then the stdlib ``wave`` module
(reading PCM 8/16/24/32-bit WAV, writing 16-bit WAV only).  The bytes
written are the JAX package's for the same array.
"""
from __future__ import annotations

import importlib.util
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def _have_soundfile() -> bool:
    return importlib.util.find_spec("soundfile") is not None


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
    if _have_soundfile():
        import soundfile as sf
        data, sr = sf.read(path, dtype="float32", always_2d=True)   # [S, C]
        return np.ascontiguousarray(data.T), int(sr)
    with wave.open(path, "rb") as w:
        sr, ch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    x = _pcm_to_float(raw, width)
    return np.ascontiguousarray(x.reshape(-1, ch).T), int(sr)


def write_audio(path: PathLike, samples_cn, sr: int, subtype: str = "PCM_16") -> None:
    """Write ``[C, S]`` float32 to a file, the format from the extension:
    ``subtype`` "PCM_16" (default) or a 32-bit / "FLOAT" one for WAV."""
    path = str(path)
    lower = path.lower()
    s = np.asarray(samples_cn, dtype=np.float32)
    if s.ndim == 1:
        s = s[None, :]
    if lower.endswith((".wav", ".flac")):
        from . import native
        try:
            if lower.endswith(".wav"):
                bits = 32 if "32" in subtype or "FLOAT" in subtype.upper() else 16
                native.write_wav(path, s, int(sr), bits)
            else:
                native.write_flac(path, s, int(sr))
            return
        except RuntimeError:
            pass
    if _have_soundfile():
        import soundfile as sf
        sf.write(path, s.T, int(sr), subtype=subtype)
        return
    if not lower.endswith(".wav"):
        raise RuntimeError(f"soundfile unavailable; the stdlib fallback writes WAV only "
                           f"(got {path})")
    pcm = (np.clip(s.T, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(s.shape[0])
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm.tobytes())
