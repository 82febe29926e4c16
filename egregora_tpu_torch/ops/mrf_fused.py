"""Wrapper of the channel-major MRF entry of ``csrc/mrf.cu``.

The port of ``egregora_tpu/ops/mrf_pallas.py::mrf_fused_cm``: one whole
HiFi-GAN MRF block (every ResBlock branch and their mean) on ``[B, C,
T]`` in one launch, bf16 or float32, any C.  A CUDA tensor goes to the
kernel or raises; a CPU tensor goes to the plain version,
``mrf_fused_cm_plain``, which rounds where the TPU kernel's
``_conv_circ`` does: each conv's f32 sum to the activation dtype, then
the bias in that dtype.

On the card (``kernel_operands``) bf16 operands are padded with zero
channels to the width the warpgroup-MMA core runs (``kernel_width``: 16,
32 or a multiple of 64; zero activations, weights and bias stay exactly 0
through leaky, the convs and the residual, so the real channels are
unchanged), and ``bf16_plan`` mirrors the core's tile plan (the library
reports its own through ``mrf_bf16_layout``); float32 operands keep their
C and travel with each conv's weights transposed to ``[k, C_in, C_out]``,
with a device workspace when the tiles do not fit shared memory.

Weights travel packed (``pack_resblock_weights``): ``w`` is one flat
tensor holding, per branch, dilation iteration and conv (dilated, unit),
the kernel as ``[k, C_out, C_in]``; ``bias`` is float32 ``[branches,
dilations, 2, C]``.
"""
from __future__ import annotations

import collections
import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from .fir import exact_f32

# kernel launches since the last reset, in all and by shape (b, c, t);
# counted where the kernel launches and nowhere else
launches = 0
launches_by_shape: collections.Counter = collections.Counter()

_FN = None
_WS = None


def branch_halo(k: int, dilations: Sequence[int]) -> int:
    """Per-side reach of one ResBlock chain: ``sum_d ((k-1)//2)(d+1)``."""
    return sum(((k - 1) // 2) * (d + 1) for d in dilations)


# the bf16 core's block (csrc/mrf_core.cuh): 227 KB of shared memory at
# most, two consumer warpgroups and a producer warp, a weight ring of up
# to 8 slots
SMEM_LIMIT = 232448
THREADS = 288
MAX_STAGES = 8


class Bf16Plan(NamedTuple):
    """The bf16 block of ``csrc/mrf_core.cuh`` (``mrf_bf16_layout``'s
    answer, in its order)."""
    c: int            # channels the kernel runs (C padded with zeros)
    tt: int           # time tile of a block
    threads: int
    smem_bytes: int   # dynamic shared memory
    stages: int       # slots of the weight ring
    nc: int           # output channels of one accumulator pass (wgmma N)
    q: int            # taps a weight slice holds
    lk: int           # 1: leaky(h) kept in a tile of its own


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_width(c: int) -> int:
    """Channels the bf16 core runs for C: 16, 32 or a multiple of 64."""
    return 16 if c <= 16 else 32 if c <= 32 else _round_up(c, 64)


def bf16_plan(c: int, t: int, halo: int, nb: int, cm: bool) -> Optional[Bf16Plan]:
    """``make_plan`` of ``csrc/mrf_core.cuh``: for C channels (padded to
    ``kernel_width``), T samples, a halo of ``halo`` a side, ``nb``
    branches (a branch-sum tile when more than one), channel-major ``cm``
    (a transpose staging tile) or not.  The time tile is the largest
    multiple of 16, at most ``2 MT 64 - 128`` (one pass of the M tiles a
    warpgroup keeps in registers over the first conv's rows) and no longer
    than T needs, whose tiles fit 227 KB beside a 32 KB weight ring (two
    slots where that leaves none).  A third tile holding leaky(h) is kept
    where the time tile it leaves is no shorter than 256 samples or than
    the tile without it; the ring then grows into what is left, up to 8
    slots.  None where no tile fits."""
    c = kernel_width(c)
    nc = c if c <= 128 else (128 if c % 128 == 0 else 64)
    pb = min(c, 64) * 2
    q = 1 if nc < c else {16: 16, 32: 8, 64: 2, 128: 1}[nc]
    slice_bytes = q * nc * pb
    mt = {16: 8, 32: 6, 64: 4, 128: 2}[nc]
    hl = _round_up(halo, 8)

    def smem(tt: int, stages: int, lk: int) -> int:
        rows = _round_up(hl + tt + halo, 16)
        sp = rows if (rows // 8) % 2 else rows + 8
        cur = rows * c * 2
        tmp = max(cur, c * sp * 2) if cm else cur
        branch_sum = tt * c * 2 if nb > 1 else 0
        return (_round_up(cur, 1024) * (1 + lk) + _round_up(tmp, 1024)
                + _round_up(branch_sum, 1024) + stages * slice_bytes + 16 * stages + 1024)

    def longest(lk: int) -> Tuple[int, int]:
        ring = 32768 // slice_bytes
        for stages in ((ring, 2) if ring > 2 else (2,)):
            for tt in range(min(2 * mt * 64 - 128, _round_up(t, 16)), 15, -16):
                if smem(tt, stages, lk) <= SMEM_LIMIT:
                    return tt, stages
        return 0, 0

    (plain, plain_stages), (with_lk, lk_stages) = longest(0), longest(1)
    if with_lk and with_lk >= min(plain, 256):
        tt, stages, lk = with_lk, lk_stages, 1
    elif plain:
        tt, stages, lk = plain, plain_stages, 0
    else:
        return None
    while stages < MAX_STAGES and smem(tt, stages + 1, lk) <= SMEM_LIMIT:
        stages += 1
    return Bf16Plan(c, tt, THREADS, smem(tt, stages, lk), stages, nc, q, lk)


def pack_resblock_weights(mrf: torch.nn.Module, dtype: torch.dtype
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An ``MRF`` module's convs -> ``(w, bias)``, the kernels' format:
    ``ResBlock1D_{b}.Conv_{2m}`` is iteration m's dilated conv,
    ``Conv_{2m+1}`` its unit conv; torch's ``[C_out, C_in, k]`` becomes
    ``[k, C_out, C_in]``."""
    ws, bs = [], []
    for bi in range(mrf.n):
        rb = getattr(mrf, f"ResBlock1D_{bi}")
        for j in range(2 * len(rb.dilations)):
            conv = getattr(rb, f"Conv_{j}")
            ws.append(conv.weight.detach().permute(2, 0, 1).reshape(-1))
            bs.append(conv.bias.detach().float())
    c = bs[0].shape[0]
    bias = torch.stack(bs).reshape(mrf.n, -1, 2, c)
    return torch.cat(ws).to(dtype).contiguous(), bias.contiguous()


def branch_weights(w: torch.Tensor, c: int, kernels: Sequence[int], n_dil: int
                   ) -> List[torch.Tensor]:
    """The flat packed ``w`` -> per branch ``[n_dil, 2, k, C_out, C_in]`` views."""
    out, off = [], 0
    for k in kernels:
        n = n_dil * 2 * k * c * c
        out.append(w[off: off + n].view(n_dil, 2, k, c, c))
        off += n
    if off != w.numel():
        raise ValueError(f"packed MRF weights hold {w.numel()} values, kernels "
                         f"{tuple(kernels)} x {n_dil} dilations at C={c} need {off}")
    return out


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def _conv(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, d: int,
          round_then_bias: bool) -> torch.Tensor:
    """'SAME' dilated conv of ``a [B, C, T]`` by ``w [k, C_out, C_in]`` with
    an f32 sum; the bias joins after the rounding to ``a.dtype``
    (``_conv_circ``) or before it (``_conv_rows``)."""
    k = w.shape[0]
    with exact_f32():
        y = F.conv1d(a.float(), w.permute(1, 2, 0).float(), padding=(k - 1) // 2 * d,
                     dilation=d)
    if round_then_bias:
        return y.to(a.dtype) + bias.to(a.dtype)[:, None]
    return (y + bias.float()[:, None]).to(a.dtype)


def branch_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 dilations: Sequence[int], round_then_bias: bool) -> torch.Tensor:
    """One ResBlock chain on ``x [B, C, T]``: for each dilation d,
    ``h += conv_1(leaky(conv_d(leaky(h))))``; ``w [n_dil, 2, k, C, C]``,
    ``bias [n_dil, 2, C]``."""
    h = x
    for m, d in enumerate(dilations):
        a = _conv(_leaky(h), w[m, 0], bias[m, 0], d, round_then_bias)
        a = _conv(_leaky(a), w[m, 1], bias[m, 1], 1, round_then_bias)
        h = h + a
    return h


def mrf_fused_cm_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       kernels: Sequence[int], dilations: Sequence[int]) -> torch.Tensor:
    """The plain version: the branches' mean in ``x.dtype``, as
    ``_mrf_kernel`` sums and divides."""
    acc = None
    for bi, wb in enumerate(branch_weights(w, x.shape[1], kernels, len(dilations))):
        h = branch_plain(x, wb, bias[bi], dilations, round_then_bias=True)
        acc = h if acc is None else acc + h
    return acc / len(kernels)


def _kernel(dtype: torch.dtype):
    global _FN
    if _FN is None:
        lib = cuda_build.load("mrf")
        fns = {}
        for dt, sym in ((torch.bfloat16, "mrf_fused_cm_bf16"), (torch.float32, "mrf_fused_cm_f32")):
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_void_p] * (
                    2 if dt == torch.float32 else 1)
            fn.restype = ctypes.c_int
            fns[dt] = fn
        _FN = fns
    return _FN[dtype]


def workspace(x: torch.Tensor, b: int, c: int, t: int, kernels: Sequence[int],
              dilations: Sequence[int]) -> torch.Tensor:
    """The float32 entries' device workspace (empty when their tiles fit
    shared memory)."""
    global _WS
    if _WS is None:
        fn = cuda_build.load("mrf").mrf_f32_workspace_floats
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_longlong
        _WS = fn
    ks = (ctypes.c_int * len(kernels))(*kernels)
    ds = (ctypes.c_int * len(dilations))(*dilations)
    n = _WS(b, c, t, len(kernels), ks, len(dilations), ds)
    if n < 0:
        raise ValueError(f"mrf: unsupported operands b={b} c={c} t={t} kernels "
                         f"{tuple(kernels)} dilations {tuple(dilations)}")
    return torch.empty(n, dtype=torch.float32, device=x.device)


def kernel_operands(x: torch.Tensor, w: torch.Tensor, branches: List[torch.Tensor],
                    bias: torch.Tensor, channel_dim: int):
    """``(x, w, bias, C)`` as the entries of ``csrc/mrf.cu`` take them.
    ``branches`` are ``w``'s per-branch views ``[..., C_out, C_in]``.
    bf16: C padded with zero channels to ``kernel_width(C)``; float32:
    each conv's weights transposed to ``[k, C_in, C_out]``."""
    c = x.shape[channel_dim]
    if x.dtype == torch.float32:
        return x, torch.cat([wb.transpose(-1, -2).reshape(-1) for wb in branches]), bias, c
    p = kernel_width(c) - c
    if not p:
        return x, w, bias, c
    x_pad = [0, 0] * (x.dim() - 1 - channel_dim % x.dim()) + [0, p]
    w = torch.cat([F.pad(wb, (0, p, 0, p)).reshape(-1) for wb in branches])
    return F.pad(x, x_pad), w, F.pad(bias, (0, p)).contiguous(), c + p


def check_operands(name: str, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   c: int, n_w: int, n_b: int) -> None:
    """The kernels' contract on a CUDA call: bf16 or float32 contiguous
    activations and weights of one dtype, f32 contiguous bias, all on one
    device, and weights and bias of the sizes the kernel sizes imply."""
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32 activations "
                        f"and weights of the same dtype, got {x.dtype} and {w.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name}: bias must be float32, got {bias.dtype}")
    for label, t in (("weights", w), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name}: {label} on {t.device}, activations on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the activations must be contiguous")
    if c <= 0:
        raise ValueError(f"{name}: channels {c} are not positive")
    if w.numel() != n_w or bias.numel() != n_b:
        raise ValueError(f"{name}: weights hold {w.numel()} values and bias "
                         f"{bias.numel()}, the kernel sizes need {n_w} and {n_b}")


def check_tile(name: str, x: torch.Tensor, c: int, t: int, kernels: Sequence[int],
               dilations: Sequence[int], cm: bool) -> None:
    """Raises where no bf16 block of the core fits shared memory (C too
    wide for the chain's halo)."""
    halo = max(branch_halo(k, dilations) for k in kernels)
    if x.dtype == torch.bfloat16 and bf16_plan(c, t, halo, len(kernels), cm) is None:
        raise ValueError(f"{name}: no bf16 tile of C={c} with a halo of {halo} samples fits "
                         f"{SMEM_LIMIT} bytes of shared memory")


def mrf_fused_cm(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 kernels: Sequence[int] = (3, 7, 11),
                 dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """``[B, C, T] -> [B, C, T]``: one MRF block with zero-padded edges."""
    if x.device.type == "cpu":
        return mrf_fused_cm_plain(x, w, bias, kernels, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_fused_cm: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"mrf_fused_cm: expected [B, C, T], got {tuple(x.shape)}")
    b, c, t = x.shape
    nb, nd = len(kernels), len(dilations)
    check_operands("mrf_fused_cm", x, w, bias, c,
                   2 * nd * sum(kernels) * c * c, nb * nd * 2 * c)
    if not (0 < nb <= 4 and 0 < nd <= 4 and 0 < b <= 65535 and t > 0):
        raise ValueError(f"mrf_fused_cm: unsupported shape {tuple(x.shape)}, "
                         f"kernels {tuple(kernels)}, dilations {tuple(dilations)}")
    check_tile("mrf_fused_cm", x, c, t, kernels, dilations, cm=True)
    x, w, bias, ck = kernel_operands(x, w, branch_weights(w, c, kernels, nd), bias, 1)
    extra = ()
    if x.dtype == torch.float32:
        ws = workspace(x, b, c, t, kernels, dilations)   # held until the launch is queued
        extra = (ws.data_ptr(),)
    y = torch.empty_like(x)
    ks = (ctypes.c_int * nb)(*kernels)
    ds = (ctypes.c_int * nd)(*dilations)
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 b, ck, t, nb, ks, nd, ds, *extra, stream)
    if err:
        raise RuntimeError(f"mrf_fused_cm: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(b, c, t)] += 1
    return y if ck == c else y[:, :c].contiguous()
