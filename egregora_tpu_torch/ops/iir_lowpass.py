"""Wrapper of the hand-written first-order IIR scan ``csrc/iir_lowpass.cu``.

The port of ``egregora_tpu/ops/pallas_iir.py::iir_lowpass_pallas`` (K4):
``z[n] = (1-k) x[n] + k z[n-1]``, z[-1] = 0, along each row of ``[C, N]``
float32, all channels in one call (two or three kernel launches, counted
as one call, as the other wrappers count).  A CUDA tensor goes to the
kernel or raises; a CPU tensor goes to the plain version,
``iir_lowpass_plain`` (``ops.iir.first_order_lowpass``): the blocked
recurrence with pole ``k`` on ``(1-k) x`` (a single float32 scan over
the whole signal would lose ~4e-2 for poles near 1).

The kernel takes every power of the pole from tables computed here in
float64 (``pole_tables``), one per level of its scan.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from ..utils import cuda_build
from .iir import first_order_lowpass

TILE = 4096                       # samples a block of csrc/iir_lowpass.cu scans

# calls since the last reset, in all and by shape (c, n); counted where
# the kernel launches and nowhere else
launches = 0
launches_by_shape: collections.Counter = collections.Counter()

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("iir_lowpass")
        lib.iir_lowpass_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p]
        lib.iir_lowpass_f32.restype = ctypes.c_int
        lib.iir_lowpass_levels.argtypes = [ctypes.c_longlong]
        lib.iir_lowpass_levels.restype = ctypes.c_int
        lib.iir_lowpass_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.iir_lowpass_workspace_floats.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=32)
def pole_tables(k: float, levels: int) -> np.ndarray:
    """``[levels, TILE + 1]`` float32: row l holds ``(k^(TILE^l))^j`` for
    j = 0..TILE, computed in float64 (underflow to 0 is harmless)."""
    j = np.arange(TILE + 1, dtype=np.float64)
    with np.errstate(under="ignore"):
        rows = [np.power(float(k), j * float(TILE) ** lvl) for lvl in range(levels)]
    return np.stack(rows).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_tables(k: float, levels: int, device: str) -> torch.Tensor:
    return torch.from_numpy(pole_tables(k, levels)).to(device)


# the plain version: the blocked recurrence with pole k on (1-k) x, float32
iir_lowpass_plain = first_order_lowpass


def iir_lowpass(x: torch.Tensor, k: float) -> torch.Tensor:
    """``z[n] = (1-k) x[n] + k z[n-1]`` along the last axis of float32
    ``[C, N]``."""
    if x.device.type == "cpu":
        return iir_lowpass_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"iir_lowpass: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"iir_lowpass: expected float32 [C, N], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("iir_lowpass: the signal must be contiguous")
    c, n = x.shape
    if not (0 < c <= 65535 and n > 0):
        raise ValueError(f"iir_lowpass: unsupported shape {tuple(x.shape)}")
    lib = _lib()
    tables = _device_tables(float(k), lib.iir_lowpass_levels(n), str(x.device))
    work = torch.empty(lib.iir_lowpass_workspace_floats(c, n), dtype=torch.float32,
                       device=x.device)
    z = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.iir_lowpass_f32(x.data_ptr(), z.data_ptr(), work.data_ptr(),
                                  tables.data_ptr(), c, n, float(np.float32(1.0 - k)),
                                  stream)
    if err:
        raise RuntimeError(f"iir_lowpass: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(c, n)] += 1
    return z
