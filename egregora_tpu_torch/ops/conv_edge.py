"""Wrapper of the hand-written one-output-channel 3x3 conv ``csrc/conv_edge.cu``.

The port of ``egregora_tpu/ops/conv_edge.py::conv3x3_out1``: the 'SAME'
3x3 convolution ``[B, F, M, C] x [3, 3, C, 1] -> [B, F, M, 1]`` (the
flax kernel layout) with float32 accumulation and output plus the bias,
what the VAE decoder's final ``nn.Conv(1, (3, 3))`` computes.  bf16 or
float32 input, any B, F, M and C (the JAX kernel refuses F % f_tile !=
0).  As in the JAX kernel, the weights are rounded to the input's dtype
and every product is summed in float32.

``f_tile`` is the number of rows a block of the kernel walks (rounded up
to a multiple of its 8-row step).  A CUDA tensor goes to the kernel or
raises; a CPU tensor goes to the plain version, ``conv3x3_out1_plain``,
nine shifted products over a zero-padded copy.  ``launches`` counts
kernel launches, in all and by (b, f, m, c).

Not wired into the port's VAE decoder: the JAX package never wires its
kernel in either.  ``tools/edge_conv_lab.py`` and ``chip_smoke.py``
launch it and time it against cuDNN.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from ..utils import cuda_build

ENTRIES = {torch.bfloat16: "conv_edge_bf16", torch.float32: "conv_edge_f32"}
ROW_STEP = 8        # output rows a step of a block (csrc/conv_edge.cu, TF)

# kernel launches since the last reset, in all and by shape (b, f, m, c);
# counted where the kernel launches and nowhere else
launches = 0
launches_by_shape: collections.Counter = collections.Counter()

_FNS: dict = {}


def _kernel(dtype: torch.dtype):
    fn = _FNS.get(dtype)
    if fn is None:
        fn = getattr(cuda_build.load("conv_edge"), ENTRIES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[dtype] = fn
    return fn


def _check(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"conv3x3_out1: expected x [B, F, M, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if tuple(kernel.shape) != (3, 3, c, 1):
        raise ValueError(f"conv3x3_out1: kernel {tuple(kernel.shape)} is not [3, 3, {c}, 1]")
    if bias.numel() != 1:
        raise ValueError(f"conv3x3_out1: bias must hold one value, got {tuple(bias.shape)}")


def conv3x3_out1_plain(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Nine shifted ``[.., C] @ [C]`` products over the zero-padded input
    in float32, with the weights rounded to x's dtype, plus the bias."""
    _check(x, kernel, bias)
    b, f, m, _ = x.shape
    w = kernel[..., 0].to(x.dtype).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    out = torch.zeros(b, f, m, dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            out = out + torch.matmul(xp[:, di:di + f, dj:dj + m], w[di, dj])
    return (out + bias.reshape(-1)[0].float())[..., None]


def conv3x3_out1(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 f_tile: int = 64) -> torch.Tensor:
    """``[B, F, M, C] x [3, 3, C, 1] -> [B, F, M, 1]`` float32 ('SAME')."""
    if x.device.type == "cpu":
        return conv3x3_out1_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_out1: unsupported device {x.device}")
    _check(x, kernel, bias)
    if x.dtype not in ENTRIES:
        raise TypeError(f"conv3x3_out1: the kernel takes bfloat16 or float32, got {x.dtype}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError(f"conv3x3_out1: kernel on {kernel.device}, bias on "
                         f"{bias.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv3x3_out1: x must be contiguous")
    if f_tile < 1:
        raise ValueError(f"conv3x3_out1: f_tile must be positive, got {f_tile}")
    b, f, m, c = x.shape
    if not (0 < b <= 65535 and f and m):
        raise ValueError(f"conv3x3_out1: unsupported shape {tuple(x.shape)}")
    rows = -(-min(f_tile, f) // ROW_STEP) * ROW_STEP
    w = kernel[..., 0].to(x.dtype).float().contiguous()          # [3, 3, C]
    bvec = bias.reshape(-1).float().contiguous()
    out = torch.empty(b, f, m, 1, dtype=torch.float32, device=x.device)
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), bvec.data_ptr(), out.data_ptr(),
                 b, f, m, c, rows, stream)
    if err:
        raise RuntimeError(f"conv3x3_out1: launch failed with cudaError_t {err}")
    global launches
    launches += 1
    launches_by_shape[(b, f, m, c)] += 1
    return out
