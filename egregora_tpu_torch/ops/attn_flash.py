"""Wrapper of the hand-written online-softmax attention ``csrc/attn_online.cu``.

The port of ``egregora_tpu/ops/attn_flash.py::flash_online``: exact
softmax attention ``[B*H, N, D] -> [B*H, N, D]`` that walks the key axis
in blocks of ``block_k`` with a running max (from -1e30), a running
normaliser and a float32 accumulator, for q blocks of ``block_q`` rows.
bf16 or float32, any N (the JAX kernel refuses N % block_k != 0; here the
last key block is masked) and any head size D up to 512 (another D than
32/64/128/256/512 is padded with zero columns, at the true D's scale).

``block_q`` and ``block_k`` are the kernel's tile where it is built for
them (``BF16_TILES`` / ``F32_TILES`` by D: what fits a Hopper block's
227 KB of shared memory and its registers; bf16 is the warpgroup-MMA
core of ``csrc/attn_core.cuh``, float32 runs on the SIMT cores);
otherwise each is clamped to the largest built size not above it (or the
smallest built size), so the JAX defaults (512, 1024) run as the largest
tile of that D.  The result
does not depend on the tiling beyond float32 rounding.

A CUDA tensor goes to the kernel or raises; a CPU tensor goes to the
plain version, ``flash_online_plain``, a literal block loop with
``_kernel``'s arithmetic.  ``launches`` counts kernel launches, in all
and by (bh, n, d).  No path of the node calls this kernel: the
pipeline's attention stays on ``attn_rows``, as the JAX package's stays
on ``flash_rows``; ``tools/attn_flash_lab.py`` and ``chip_smoke.py``
launch it.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from ..utils.profiling import is_recording
from .attn_rows import FLOP_LOG      # one FLOP log with attn_rows, as in the JAX package

KERNEL_D = (32, 64, 128, 256, 512)     # head sizes csrc/attn_online.cu is built for
# (block_q options, block_k options) built for each D: bf16 runs 64 q
# rows a block (D = 512: two warpgroups split D over them, 32-key tiles to
# fit the K/V ring); the library's attn_online_bf16_layout query answers
# for the same tiles (held to it on the card)
BF16_TILES = {32: ((64,), (64, 128)), 64: ((64,), (64, 128)), 128: ((64,), (64, 128)),
              256: ((64,), (64,)), 512: ((64,), (32,))}
F32_TILES = {32: ((32, 64), (32, 64)), 64: ((32, 64), (32, 64)),
             128: ((32, 64), (32, 64)), 256: ((32, 64), (32,)), 512: ((16,), (32,))}
ENTRIES = {torch.bfloat16: ("attn_online_bf16", BF16_TILES),
           torch.float32: ("attn_online_f32", F32_TILES)}
M_INIT = -1e30                          # flash_online's initial running max

# kernel launches since the last reset, in all and by shape (bh, n, d);
# counted where the kernel launches and nowhere else
launches = 0
launches_by_shape: collections.Counter = collections.Counter()

_FNS: dict = {}


def _kernel(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(cuda_build.load("attn_online"), ENTRIES[dtype][0])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def _clamp(want: int, built) -> int:
    fit = [b for b in built if b <= want]
    return max(fit) if fit else min(built)


def kernel_tile(dtype: torch.dtype, d: int, block_q: int, block_k: int):
    """``(D the kernel runs, block_q, block_k)`` for a call at head size
    ``d``: the built tile the requested blocks clamp to."""
    dk = next(s for s in KERNEL_D if s >= d)
    bqs, bks = ENTRIES[dtype][1][dk]
    return dk, _clamp(block_q, bqs), _clamp(block_k, bks)


def flash_online_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """flash_online's ``_kernel`` as a literal loop over q and k blocks:
    f32 scores scaled after the product, running max from -1e30, ``l``
    summed over the f32 weights, weights rounded to v's dtype for P.V,
    f32 accumulator divided by ``l``; the last key block may be short."""
    n, d = q.shape[-2:]
    scale = float(d) ** -0.5
    bq, bk = max(1, min(block_q, n)), max(1, min(block_k, n))
    out = torch.empty_like(q)
    for i in range(0, n, bq):
        qb = q[:, i:i + bq].float()
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qb.shape[:-1] + (1,), M_INIT, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        for j in range(0, n, bk):
            s = torch.matmul(qb, k[:, j:j + bk].float().transpose(1, 2)) * scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            corr = torch.exp(m - m_new)
            e = torch.exp(s - m_new)
            l = l * corr + e.sum(dim=-1, keepdim=True)
            m = m_new
            pv = torch.matmul(e.to(v.dtype).float(), v[:, j:j + bk].float())
            acc = acc * corr + pv
        out[:, i:i + bq] = (acc / l).to(q.dtype)
    return out


def flash_online(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """Exact attention ``[BH, N, D]`` (scale ``D**-0.5``), k-blocked."""
    if is_recording() and q.dim() >= 2:
        FLOP_LOG.append(4 * q.shape[:-2].numel() * q.shape[-2] ** 2 * q.shape[-1])
    if q.device.type == "cpu":
        return flash_online_plain(q, k, v, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_online: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash_online: {name} {tuple(t.shape)} {t.dtype} "
                             f"{t.device} does not match q {tuple(q.shape)} "
                             f"{q.dtype} {q.device}")
    if q.dtype not in ENTRIES:
        raise TypeError(f"flash_online: the kernel takes bfloat16 or float32, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"flash_online: expected [BH, N, D], got {tuple(q.shape)}")
    bh, n, d = q.shape
    if not 0 < d <= KERNEL_D[-1]:
        raise ValueError(f"flash_online: head dim {d} is beyond the kernel's range: "
                         f"its tiles hold at most {KERNEL_D[-1]} columns")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_online: q, k and v must be contiguous")
    if not 0 < bh <= 65535 or n == 0:
        raise ValueError(f"flash_online: unsupported shape {tuple(q.shape)}")
    if block_q < 1 or block_k < 1:
        raise ValueError(f"flash_online: block sizes must be positive, got "
                         f"({block_q}, {block_k})")
    dk, bq, bk = kernel_tile(q.dtype, d, block_q, block_k)
    if dk != d:
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    o = torch.empty_like(q)
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 bh, n, dk, bq, bk, float(d) ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_online: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(bh, n, d)] += 1
    return o if dk == d else o[..., :d].contiguous()
