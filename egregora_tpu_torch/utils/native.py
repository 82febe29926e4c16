"""ctypes bindings of the repo's native audio codec (``native/``), read side.

Counterpart of ``egregora_tpu/utils/native.py`` for what ``utils.wavio``
reads: ``read_wav`` and ``read_flac``.  The library is built from
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
from typing import Optional, Tuple

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
    if hasattr(lib, "fc_read"):
        lib.fc_read.restype = ctypes.c_int
        lib.fc_read.argtypes = read_args
        lib.fc_free.restype = None
        lib.fc_free.argtypes = [ctypes.c_void_p]
        lib.fc_last_error.restype = ctypes.c_char_p
        lib.fc_last_error.argtypes = []
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


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """A FLAC through the native codec -> ([C, S] float32, sr)."""
    return _read(path, "fc")
