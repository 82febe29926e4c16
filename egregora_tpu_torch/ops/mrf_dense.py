"""Channel-major dense MRF: the JAX package's plain-XLA MRF engine.

Counterpart of ``egregora_tpu/ops/mrf_dense.py`` (``EGREGORA_MRF_PATH=
dense``): the contract of ``ops.mrf_fused.mrf_fused_cm`` (``[B, C, T] ->
[B, C, T]``, zero-padded edges, one dilation schedule for every branch,
the packed ``(w, bias)`` of ``mrf_fused.pack_resblock_weights``), built
from static time slices of the zero-padded activation, each contracted
with its tap's ``[C_out, C_in]`` block in float32 (the output rounded to
the activation dtype before the bias add, flax ``nn.Conv(dtype=...)``
semantics).  It is a layout engine of XLA with no Pallas kernel behind
it, so here it stays plain PyTorch on every device: cuBLAS products on
the card, in true float32 (``ops.fir.exact_f32``), not TF32.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from .fir import exact_f32
from .mrf_fused import branch_weights


def _leaky(v: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(v, 0.1)


def _conv_cm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, d: int) -> torch.Tensor:
    """Dilated 'SAME' conv of ``a [B, C, T]`` by ``w [k, C_out, C_in]``: k
    time slices of the padded activation, one float32 product a tap."""
    k, t = w.shape[0], a.shape[2]
    p = (k - 1) // 2 * d
    ap = F.pad(a, (p, p)).float()
    wf = w.float()
    y = None
    with exact_f32():
        for j in range(k):
            yj = torch.matmul(wf[j], ap[:, :, j * d: j * d + t])
            y = yj if y is None else y + yj
    return y.to(a.dtype) + bias.to(a.dtype)[:, None]


def mrf_dense_cm(x_cm: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 kernels: Sequence[int] = (3, 7, 11),
                 dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """``[B, C, T] -> [B, C, T]`` multi-receptive-field stack, a drop-in for
    ``mrf_fused_cm`` with its packed weights: for each branch and dilation
    d, ``h += conv_1(leaky(conv_d(leaky(h))))``, then the branches' mean."""
    acc = None
    for bi, wb in enumerate(branch_weights(w, x_cm.shape[1], kernels, len(dilations))):
        cur = x_cm
        for m, d in enumerate(dilations):
            c1 = _conv_cm(_leaky(cur), wb[m, 0], bias[bi, m, 0], d)
            c2 = _conv_cm(_leaky(c1), wb[m, 1], bias[bi, m, 1], 1)
            cur = cur + c2
        acc = cur if acc is None else acc + cur
    return acc / float(len(kernels))
