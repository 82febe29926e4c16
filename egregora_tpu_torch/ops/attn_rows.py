"""Wrapper of the hand-written attention kernel ``csrc/attn_rows.cu``.

The port of ``egregora_tpu/ops/attn_pallas.py::flash_rows``: exact
softmax attention ``[B*H, N, D] -> [B*H, N, D]`` in bf16 or float32,
for any head size D up to 512 (the published checkpoints' VAE mid block
runs one head of 512).  The kernel is built for D in ``KERNEL_D``;
another D is padded with zero columns to the next of them
(zero columns add nothing to q.k, and the padded value columns are
dropped), with the scale of the true D.  The bf16 kernel is the
warpgroup-MMA core of ``csrc/attn_core.cuh`` (TMA K/V ring, O in
registers) with flash_rows's rounding; float32 runs on the SIMT cores.
A CUDA tensor goes to the kernel or raises; a CPU tensor goes to the
plain version,
``ops.attention.chunked_attention``, which has flash_rows's math
(f32 scores scaled after the product, true row max, weights rounded to
the value dtype, f32 accumulation).
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from ..utils import cuda_build

KERNEL_D = (32, 64, 128, 256, 512)     # head sizes csrc/attn_rows.cu is built for
# bf16 tile by D: (q rows a block, keys a K/V tile).  A ring slot holds
# one K and one V tile, and at D = 512 only 32 keys fit (two warpgroups
# split D over the 64 rows).  The library's attn_rows_bf16_layout query
# answers for the same tiles (held to it on the card)
BF16_TILES = {32: (64, 128), 64: (64, 128), 128: (64, 128), 256: (64, 64), 512: (64, 32)}
ENTRIES = {torch.bfloat16: "attn_rows_bf16", torch.float32: "attn_rows_f32"}

# kernel launches since the last reset, in all and by shape (bh, n, d);
# counted where the kernel launches and nowhere else
launches = 0
launches_by_shape: collections.Counter = collections.Counter()

_FNS: dict = {}


def _kernel(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(cuda_build.load("attn_rows"), ENTRIES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def kernel_tile(d: int) -> tuple:
    """``(D the kernel runs, q rows a block, keys a tile)`` of the bf16
    kernel at head size ``d``."""
    dk = next(s for s in KERNEL_D if s >= d)
    return (dk,) + BF16_TILES[dk]


def attn_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention ``[BH, N, D]`` (scale ``D**-0.5``)."""
    if q.device.type == "cpu":
        from .attention import chunked_attention
        return chunked_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"attn_rows: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"attn_rows: {name} {tuple(t.shape)} {t.dtype} "
                             f"{t.device} does not match q {tuple(q.shape)} "
                             f"{q.dtype} {q.device}")
    if q.dtype not in ENTRIES:
        raise TypeError(f"attn_rows: the kernel takes bfloat16 or float32, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"attn_rows: expected [BH, N, D], got {tuple(q.shape)}")
    bh, n, d = q.shape
    if not 0 < d <= KERNEL_D[-1]:
        raise ValueError(f"attn_rows: head dim {d} is beyond the kernel's range: its "
                         f"tiles hold at most {KERNEL_D[-1]} columns in shared memory")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attn_rows: q, k and v must be contiguous")
    if not 0 < bh <= 65535 or n == 0:
        raise ValueError(f"attn_rows: unsupported shape {tuple(q.shape)}")
    dk = next(s for s in KERNEL_D if s >= d)
    if dk != d:
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    o = torch.empty_like(q)
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 bh, n, dk, float(d) ** -0.5, stream)
    if err:
        raise RuntimeError(f"attn_rows: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(bh, n, d)] += 1
    return o if dk == d else o[..., :d].contiguous()
