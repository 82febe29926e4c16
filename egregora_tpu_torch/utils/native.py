"""ctypes bindings of the repo's native audio codec (``native/``).

Counterpart of ``egregora_tpu/utils/native.py``: what ``utils.wavio``
reads and writes (``read_wav``, ``read_flac``, ``write_wav``, 16-bit PCM
or 32-bit float, and ``write_flac``, 16-bit), and ``read_wav_batch``, the
library's threaded decode of many WAVs.  The library is built from
``native/wavcodec.cc`` and ``native/flaccodec.cc`` with g++ at first use
into the port's build directory, ``egregora_tpu_torch/_build/`` (never
under ``native/``), keyed by a hash of the sources and flags.  Where
there is no toolchain, ``load`` returns None and the readers raise, so
``utils.wavio`` falls back to the next backend.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("wavcodec.cc", "flaccodec.cc")
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")   # portable: no -march

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Optional[Path]:
    """``_build/libwavcodec-<hash>.so`` for the present sources, or None
    where ``native/`` has none of them."""
    srcs = [NATIVE_DIR / s for s in SOURCES if (NATIVE_DIR / s).exists()]
    if not srcs:
        return None
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    return BUILD_DIR / f"libwavcodec-{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile the codec unless it is built already; None where it cannot
    be built (no sources, no g++, a failed compile)."""
    so = library_path()
    if so is None or so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    srcs = [str(NATIVE_DIR / s) for s in SOURCES if (NATIVE_DIR / s).exists()]
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), *srcs], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)
    return so


def load() -> Optional[ctypes.CDLL]:
    """The codec library, built at first use; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    read_args = [ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
                 ctypes.POINTER(ctypes.c_int)]
    lib.wc_read.restype = ctypes.c_int
    lib.wc_read.argtypes = read_args
    lib.wc_free.restype = None
    lib.wc_free.argtypes = [ctypes.c_void_p]
    lib.wc_last_error.restype = ctypes.c_char_p
    lib.wc_last_error.argtypes = []
    lib.wc_write.restype = ctypes.c_int
    lib.wc_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.wc_read_batch.restype = None
    lib.wc_read_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
                                  ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    if hasattr(lib, "fc_read"):
        lib.fc_read.restype = ctypes.c_int
        lib.fc_read.argtypes = read_args
        lib.fc_free.restype = None
        lib.fc_free.argtypes = [ctypes.c_void_p]
        lib.fc_last_error.restype = ctypes.c_char_p
        lib.fc_last_error.argtypes = []
        lib.fc_write.restype = ctypes.c_int
        lib.fc_write.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int, ctypes.c_long, ctypes.c_int]
    _LIB = lib
    return _LIB


def _read(path: str, prefix: str) -> Tuple[np.ndarray, int]:
    lib = load()
    if lib is None or not hasattr(lib, f"{prefix}_read"):
        raise RuntimeError(f"native {prefix} codec unavailable")
    data = ctypes.POINTER(ctypes.c_float)()
    ch, frames, sr = ctypes.c_int(), ctypes.c_long(), ctypes.c_int()
    rc = getattr(lib, f"{prefix}_read")(str(path).encode(), ctypes.byref(data),
                                         ctypes.byref(ch), ctypes.byref(frames),
                                         ctypes.byref(sr))
    if rc != 0:
        err = getattr(lib, f"{prefix}_last_error")().decode()
        raise RuntimeError(f"native {prefix} read failed ({rc}): {err}")
    try:
        arr = np.ctypeslib.as_array(data, shape=(ch.value * frames.value,)).copy()
    finally:
        getattr(lib, f"{prefix}_free")(data)
    return arr.reshape(ch.value, frames.value), sr.value


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """A WAV through the native codec -> ([C, S] float32, sr); raises
    RuntimeError where it cannot (the caller falls back)."""
    return _read(path, "wc")


def read_wav_batch(paths: Sequence[str], n_threads: int = 0
                   ) -> List[Optional[Tuple[np.ndarray, int]]]:
    """Many WAVs decoded by the library's threads (``wc_read_batch``;
    ``n_threads`` 0: one a core) -> ``[([C, S] float32, sr) or None]``, in
    ``paths``' order, None where a file could not be read.  Each buffer the
    library allocated is copied, then freed, every one of them even where
    a copy fails."""
    lib = load()
    if lib is None:
        raise RuntimeError("native wavcodec unavailable")
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    datas = (ctypes.POINTER(ctypes.c_float) * n)()
    chans, frames, srs = (ctypes.c_int * n)(), (ctypes.c_long * n)(), (ctypes.c_int * n)()
    lib.wc_read_batch(c_paths, n, datas, chans, frames, srs, int(n_threads))
    out: List[Optional[Tuple[np.ndarray, int]]] = []
    try:
        for i in range(n):
            if not datas[i]:
                out.append(None)
                continue
            arr = np.ctypeslib.as_array(datas[i], shape=(chans[i] * frames[i],)).copy()
            out.append((arr.reshape(chans[i], frames[i]), srs[i]))
    finally:
        for i in range(n):
            if datas[i]:
                lib.wc_free(datas[i])
    return out


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """A FLAC through the native codec -> ([C, S] float32, sr)."""
    return _read(path, "fc")


def _write(path: str, prefix: str, samples_cn: np.ndarray, *args: int) -> None:
    lib = load()
    if lib is None or not hasattr(lib, f"{prefix}_write"):
        raise RuntimeError(f"native {prefix} codec unavailable")
    s = np.ascontiguousarray(samples_cn, dtype=np.float32)
    if s.ndim == 1:
        s = s[None, :]
    rc = getattr(lib, f"{prefix}_write")(str(path).encode(),
                                          s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                          s.shape[0], s.shape[1], *args)
    if rc != 0:
        err = getattr(lib, f"{prefix}_last_error")().decode()
        raise RuntimeError(f"native {prefix} write failed ({rc}): {err}")


def write_wav(path: str, samples_cn: np.ndarray, sr: int, bits: int = 16) -> None:
    """``[C, S]`` float32 -> a WAV through the native codec: 16-bit PCM
    (``round(x * 32768)``, clipped) or, at ``bits=32``, IEEE float."""
    _write(path, "wc", samples_cn, int(sr), int(bits))


def write_flac(path: str, samples_cn: np.ndarray, sr: int) -> None:
    """``[C, S]`` float32 -> a 16-bit FLAC through the native codec."""
    _write(path, "fc", samples_cn, int(sr))
