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
plain version, ``attn_rows_plain``, which has flash_rows's math (f32
scores scaled after the product, true row max, weights rounded to the
value dtype, f32 accumulation).

The kernel writes through raw pointers, so its output carries no
``grad_fn``.  Where autograd records (a training step), ``attn_rows``
runs as ``AttnRows``, a ``torch.autograd.Function``: the same forward
(the kernel on the card, the plain version on the CPU) and a plain
PyTorch backward, ``attn_rows_backward``, the exact softmax-attention
gradient recomputed from the saved q, k, v a query block at a time (the
JAX package's Pallas kernels have no backward kernel either: autodiff
there goes through XLA).  Under ``no_grad`` / ``inference_mode`` it
launches exactly what it did before.
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
# the FLOPs of every call of the public function, appended whatever the
# route (kernel or plain): an operator-level count sees none of a hand
# kernel's work, as XLA's cost analysis sees none of a Pallas call's
# (the JAX ``attn_pallas.FLOP_LOG``: ``4 * BH * N * N * D`` a call, one
# list with ``attn_flash.flash_online``; the backward logs nothing)
FLOP_LOG: list = []

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


def attn_rows_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block: int = 256) -> torch.Tensor:
    """The plain version: exact attention ``[B, N, D]`` a query block at a
    time, with flash_rows's rounding.  Each block's whole score row
    ``[block, N]`` is formed in f32 (scale applied after the product),
    softmaxed with the true row max, rounded to the value dtype and
    multiplied into v with f32 accumulation; the output takes q's dtype."""
    n, d = q.shape[-2:]
    scale = d ** -0.5
    kt, vf = k.float().transpose(1, 2), v.float()
    out = torch.empty_like(q)
    for i in range(0, n, block):
        s = torch.matmul(q[:, i:i + block].float(), kt) * scale
        w = torch.softmax(s, dim=-1).to(v.dtype)
        out[:, i:i + block] = torch.matmul(w.float(), vf).to(q.dtype)
    return out


def attn_rows_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, do: torch.Tensor, block: int = 256):
    """``(dq, dk, dv)`` of ``o = softmax(q k^T s) v`` (``s = D**-0.5``)
    for the incoming gradient ``do``, in plain PyTorch, a query block at
    a time so that no ``[N, N]`` matrix is kept: P from the float32
    scores scaled after the product (flash_rows's rounding),
    ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P * (dP - rowsum(dO * O))``,
    ``dQ = dS K s``, ``dK = dS^T Q s``; float32 sums, the inputs' dtypes
    out."""
    n, d = q.shape[-2:]
    scale = d ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)        # rowsum(dO * O)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    kt, vt = kf.transpose(1, 2), vf.transpose(1, 2)
    for i in range(0, n, block):
        rows = slice(i, i + block)
        p = torch.softmax(torch.matmul(qf[:, rows], kt) * scale, dim=-1)
        dv += torch.matmul(p.transpose(1, 2), dof[:, rows])
        ds = p * (torch.matmul(dof[:, rows], vt) - delta[:, rows])
        dq[:, rows] = torch.matmul(ds, kf) * scale
        dk += torch.matmul(ds.transpose(1, 2), qf[:, rows]) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class AttnRows(torch.autograd.Function):
    """``attn_rows`` with a gradient: the kernel (or, for CPU tensors, the
    plain version) forward, ``attn_rows_backward`` backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        o = _attn_rows(q, k, v)
        ctx.save_for_backward(q, k, v, o)
        return o

    @staticmethod
    def backward(ctx, do):
        return attn_rows_backward(*ctx.saved_tensors, do)


def attn_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention ``[BH, N, D]`` (scale ``D**-0.5``), through
    ``AttnRows`` where autograd records."""
    if q.dim() >= 2:
        FLOP_LOG.append(4 * q.shape[:-2].numel() * q.shape[-2] ** 2 * q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttnRows.apply(q, k, v)
    return _attn_rows(q, k, v)


def _attn_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return attn_rows_plain(q, k, v)
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
