"""Wrapper of the NWC MRF entry of ``csrc/mrf.cu``.

The port of ``egregora_tpu/ops/mrf_rows.py``: ``mrf_branch_rows`` runs
one ResBlock branch chain on ``[B, T, C]`` per launch, and ``mrf_rows``
averages the branches, three launches for the vocoder's (3, 7, 11), as
the JAX function does.  A CUDA tensor goes to the kernel or raises; a
CPU tensor goes to the plain version, ``mrf_branch_rows_plain``, which
rounds where ``_conv_rows`` does: the f32 bias joins the f32 sum before
the one rounding.  Unlike the TPU kernel, any T is taken; bf16 or
float32, any C (on the card as ``ops.mrf_fused`` says: bf16 padded to the
core's width, float32 with transposed conv weights).
Weights are ``ops.mrf_fused.pack_resblock_weights``'s.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Sequence

import torch

from ..utils import cuda_build
from ..utils.profiling import is_recording
from .mrf_fused import (branch_halo, branch_plain, branch_weights, check_operands,
                        check_tile, kernel_operands, workspace)

# kernel launches since the last reset, in all and by shape (b, t, c);
# counted where the kernel launches and nowhere else
launches = 0
launches_by_shape: collections.Counter = collections.Counter()
# the FLOPs of every call of the public function while spans record
# (``utils.profiling.is_recording``: a profiler session or a ``recording()``
# block, so that a served path grows no list), appended whatever the
# route (kernel or plain): an operator-level count sees none of a hand
# kernel's work, as XLA's cost analysis sees none of a Pallas call's
# (the JAX ``mrf_rows.FLOP_LOG``: ``4 * B * T * k * C * C * n_dil`` a
# ``mrf_branch_rows`` call; ``mrf_rows`` adds nothing of its own)
FLOP_LOG: list = []

_FN = None


def branch_span(k: int, dils: Sequence[int]) -> int:
    """Halo needed on each side for one branch's full chain (the JAX
    package's name of ``mrf_fused.branch_halo``)."""
    return branch_halo(k, dils)


def mrf_branch_rows_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                          dilations: Sequence[int]) -> torch.Tensor:
    """The plain version of one branch: ``x [B, T, C]``, ``w [n_dil, 2,
    k, C, C]``, ``bias [n_dil, 2, C]``."""
    h = branch_plain(x.transpose(1, 2), w, bias, dilations, round_then_bias=False)
    return h.transpose(1, 2)


def _kernel(dtype: torch.dtype):
    global _FN
    if _FN is None:
        lib = cuda_build.load("mrf")
        fns = {}
        for dt, sym in ((torch.bfloat16, "mrf_branch_rows_bf16"),
                        (torch.float32, "mrf_branch_rows_f32")):
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p] + [ctypes.c_void_p] * (2 if dt == torch.float32 else 1)
            fn.restype = ctypes.c_int
            fns[dt] = fn
        _FN = fns
    return _FN[dtype]


def mrf_branch_rows(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """One MRF branch fused: ``[B, T, C] -> [B, T, C]``; ``w [n_dil, 2, k,
    C, C]`` (kernel size k from its shape), ``bias [n_dil, 2, C]``."""
    if is_recording() and x.dim() == 3 and w.dim() == 5:
        b, t, c = x.shape
        FLOP_LOG.append(4 * b * t * w.shape[2] * c * c * len(dilations))
    if x.device.type == "cpu":
        return mrf_branch_rows_plain(x, w, bias, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"mrf_branch_rows: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 5:
        raise ValueError(f"mrf_branch_rows: expected x [B, T, C] and w [n_dil, 2, "
                         f"k, C, C], got {tuple(x.shape)} and {tuple(w.shape)}")
    b, t, c = x.shape
    nd, k = len(dilations), w.shape[2]
    check_operands("mrf_branch_rows", x, w, bias, c, nd * 2 * k * c * c, nd * 2 * c)
    if not (0 < nd <= 4 and k % 2 == 1 and 0 < b <= 65535 and t > 0):
        raise ValueError(f"mrf_branch_rows: unsupported shape {tuple(x.shape)}, "
                         f"k={k}, dilations {tuple(dilations)}")
    check_tile("mrf_branch_rows", x, c, t, (k,), dilations, cm=False)
    x, w, bias, ck = kernel_operands(x, w, [w], bias, -1)
    extra = ()
    if x.dtype == torch.float32:
        ws = workspace(x, b, c, t, (k,), dilations)   # held until the launch is queued
        extra = (ws.data_ptr(),)
    y = torch.empty_like(x)
    ds = (ctypes.c_int * nd)(*dilations)
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), bias.data_ptr(),
                 b, t, ck, k, nd, ds, *extra, stream)
    if err:
        raise RuntimeError(f"mrf_branch_rows: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(b, t, c)] += 1
    return y if ck == c else y[..., :c].contiguous()


def mrf_rows(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             kernels: Sequence[int] = (3, 7, 11),
             dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """A whole MRF block on ``[B, T, C]``: the mean of one
    ``mrf_branch_rows`` per kernel size."""
    acc = None
    for bi, wb in enumerate(branch_weights(w, x.shape[-1], kernels, len(dilations))):
        h = mrf_branch_rows(x, wb, bias[bi], dilations)
        acc = h if acc is None else acc + h
    return acc / len(kernels)
