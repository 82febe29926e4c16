"""Wrapper of the hand-written first-order IIR scan ``csrc/iir_lowpass.cu``.

The port of ``egregora_tpu/ops/pallas_iir.py::iir_lowpass_pallas`` (K4):
``z[n] = (1-k) x[n] + k z[n-1]``, z[-1] = 0, along each row of ``[C, N]``
float32, all channels in one call: one memset of the workspace (none
where every row is one tile) and one kernel launch, a chained scan with
decoupled look-back over 8192-sample tiles.  A CUDA tensor goes to the kernel or raises; a CPU tensor goes to
the plain version, ``iir_lowpass_plain`` (``ops.iir.first_order_lowpass``):
the blocked recurrence with pole ``k`` on ``(1-k) x`` (a single float32
scan over the whole signal would lose ~4e-2 for poles near 1).
``lookback_model`` runs the kernel's schedule on the CPU.

The kernel takes every power of the pole from a table computed here in
float64 (``pole_tables``).
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from ..utils import cuda_build
from .iir import first_order_lowpass

TILE = 8192                       # samples a block of csrc/iir_lowpass.cu scans
THREADS = 256                     # its threads (runs of TILE / THREADS samples)
WINDOW = 32                       # predecessors a step of its look-back reads
NOT_READY, AGGREGATE, INCLUSIVE = 0, 1, 2      # a tile's status word
STATUS_NAMES = ("not ready", "aggregate", "inclusive")

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
        lib.iir_lowpass_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.iir_lowpass_workspace_bytes.restype = ctypes.c_longlong
        lib.iir_lowpass_layout.argtypes = [ctypes.c_void_p]
        lib.iir_lowpass_layout.restype = None
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=32)
def pole_tables(k: float) -> np.ndarray:
    """``[TILE + 1 + WINDOW + 1]`` float32: ``k^j`` for j = 0..TILE, then
    ``(k^TILE)^j`` for j = 0..WINDOW, computed in float64 (underflow to 0
    is harmless)."""
    j = np.arange(TILE + 1, dtype=np.float64)
    w = np.arange(WINDOW + 1, dtype=np.float64)
    with np.errstate(under="ignore"):
        rows = [np.power(float(k), j), np.power(float(k), w * TILE)]
    return np.concatenate(rows).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_tables(k: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pole_tables(k)).to(device)


# the plain version: the blocked recurrence with pole k on (1-k) x, float32
iir_lowpass_plain = first_order_lowpass


def lookback_model(x: torch.Tensor, k: float, order_seed: int = 0, in_flight: int = 8,
                   seen: collections.Counter | None = None) -> torch.Tensor:
    """The kernel's single-pass schedule on the CPU, in float32.  Tiles
    are taken in (channel, tile) order, ``in_flight`` at a time; a seeded
    generator picks which tile in flight moves next, so each look-back
    finds its predecessors in a mix of states (not yet published,
    aggregate, inclusive).  A tile scans from a zero state
    (``iir_lowpass_plain`` on the tile), publishes its aggregate, then
    looks back window by window (``WINDOW`` predecessors, waiting while one
    is unpublished), sums the aggregates up to the nearest inclusive
    prefix scaled by ``(k^TILE)^j``, publishes its inclusive prefix and
    adds ``carry * k^(i+1)`` to its samples.  ``seen``, where given, counts
    the states the look-backs read, by name."""
    c, n = x.shape
    nt = -(-n // TILE)
    xp = torch.nn.functional.pad(x.float().cpu(), (0, nt * TILE - n))
    local = iir_lowpass_plain(xp.reshape(c * nt, TILE), k).numpy()
    tab = pole_tables(float(k))
    pw, pt = tab[:TILE + 1], tab[TILE + 1:]
    status = np.zeros(c * nt, np.int64)
    value = np.zeros(c * nt, np.float32)
    carry = np.zeros(c * nt, np.float32)
    phase = {}                         # tile in flight -> 0: scanning, 1: looking back
    nxt, rng = 0, np.random.default_rng(order_seed)
    while nxt < c * nt or phase:
        while nxt < c * nt and len(phase) < in_flight:
            phase[nxt] = 0
            nxt += 1
        tile = sorted(phase)[rng.integers(len(phase))]
        t = tile % nt
        if phase[tile] == 0:           # local scan done: publish the aggregate
            value[tile] = local[tile, -1]
            status[tile] = INCLUSIVE if t == 0 else AGGREGATE
            if t == 0:
                del phase[tile]
            else:
                phase[tile] = 1
            continue
        acc, scale, ready = np.float32(0), np.float32(1), True
        for j0 in range(0, t, WINDOW):
            js = np.arange(j0, j0 + WINDOW)
            st = np.where(js < t, status[np.maximum(tile - 1 - js, 0)], INCLUSIVE)
            if seen is not None:
                seen.update(STATUS_NAMES[s] for s in st[js < t])
            if (st == NOT_READY).any():
                ready = False          # spins: another tile moves first
                break
            val = np.where(js < t, value[np.maximum(tile - 1 - js, 0)], 0).astype(np.float32)
            incl = np.flatnonzero(st == INCLUSIVE)
            first = incl[0] if incl.size else WINDOW
            term = np.float32(np.sum(val[:first + 1] * pt[:first + 1], dtype=np.float32))
            acc = np.float32(acc + scale * term)
            if incl.size:
                break
            scale = np.float32(scale * pt[WINDOW])
        if not ready:
            continue
        carry[tile] = acc
        value[tile] = np.float32(local[tile, -1] + pt[1] * acc)
        status[tile] = INCLUSIVE
        del phase[tile]
    # the state before each thread's run is folded in float32 the same way
    z = local + carry[:, None] * pw[1:][None, :]
    return torch.from_numpy(z.astype(np.float32).reshape(c, nt * TILE)[:, :n]).to(x.device)


def layout() -> tuple:
    """``(TILE, THREADS, WINDOW)`` of the built library (its own query)."""
    out = (ctypes.c_int * 3)()
    _lib().iir_lowpass_layout(out)
    return tuple(out)


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
    if not (c > 0 and n > 0 and c * -(-n // TILE) < 2 ** 31):
        raise ValueError(f"iir_lowpass: unsupported shape {tuple(x.shape)}")
    lib = _lib()
    tables = _device_tables(float(k), x.device)
    z = torch.empty_like(x)
    # the library's workspace, which it zeroes (none where every row is one tile)
    nbytes = lib.iir_lowpass_workspace_bytes(c, n)
    work = torch.empty(nbytes // 8, dtype=torch.int64, device=x.device) if nbytes else None
    with cuda_build.on_device(x.device):
        err = lib.iir_lowpass_f32(x.data_ptr(), z.data_ptr(),
                                  None if work is None else work.data_ptr(),
                                  tables.data_ptr(), c, n, float(np.float32(1.0 - k)),
                                  torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"iir_lowpass: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(c, n)] += 1
    return z
