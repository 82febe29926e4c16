"""Batch-packed NWC MRF: the JAX package's grouped-conv MRF engine.

Counterpart of ``egregora_tpu/ops/mrf_packed.py`` (``EGREGORA_MRF_PATH=
packed``): ``g`` batch items are folded into the channel axis (``[B, T,
C] -> [B/g, T, g*C]``) and every conv runs with ``g`` groups, each group
applying the same weights to its own item.  On the TPU that made the
narrow stages exactly lane-wide; it is a layout engine of XLA with no
Pallas kernel behind it, so here it is plain PyTorch (grouped
``F.conv1d``, cuDNN on the card in true float32 via ``ops.fir.exact_f32``).
Numerics are flax ``nn.Conv``'s: 'SAME' zero padding, float32 sums, the
output rounded to the activation dtype before the bias add.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..models.flashsr.layers import same_pads
from .fir import exact_f32


def pack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """``[B, T, C] -> [B/g, T, g*C]``; item ``gi*m + mi`` lands in packed
    item ``mi``'s channel block ``gi`` (``m = B // g``)."""
    b, t, c = x.shape
    if b % g:
        raise ValueError(f"pack_batch: batch {b} is not a multiple of {g}")
    m = b // g
    return x.reshape(g, m, t, c).permute(1, 2, 0, 3).reshape(m, t, g * c)


def unpack_batch(x: torch.Tensor, g: int) -> torch.Tensor:
    """The inverse of ``pack_batch``: ``[B/g, T, g*C] -> [B, T, C]``."""
    m, t, gc = x.shape
    c = gc // g
    return x.reshape(m, t, g, c).permute(2, 0, 1, 3).reshape(g * m, t, c)


def conv_packed(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                d: int, g: int) -> torch.Tensor:
    """Grouped NWC conv applying one kernel ``w [C_out, C_in, k]`` (torch's
    layout, rounded to the activation dtype) to every group of ``a [M, T,
    g*C_in]`` -> ``[M, T, g*C_out]``."""
    k = w.shape[-1]
    lo, hi = same_pads(a.shape[1], k, 1, d)
    x = F.pad(a.transpose(1, 2).float(), (lo, hi))
    with exact_f32():
        y = F.conv1d(x, w.to(a.dtype).float().repeat(g, 1, 1), dilation=d, groups=g)
    return y.transpose(1, 2).to(a.dtype) + bias.to(a.dtype).repeat(g)


def _leaky(v: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(v, 0.1)


def mrf_packed(xp: torch.Tensor, mrf: torch.nn.Module, g: int,
               kernels: Sequence[int] = (3, 7, 11),
               dilations: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """Packed-domain MRF stack ``[M, T, g*C] -> [M, T, g*C]`` with the
    weights of an ``MRF`` module (``ResBlock1D_{j}.Conv_{2m(+1)}``); every
    branch shares one dilation schedule (the caller checks)."""
    acc = None
    for bi in range(len(kernels)):
        rb = getattr(mrf, f"ResBlock1D_{bi}")
        cur = xp
        for mi, d in enumerate(dilations):
            c1, c2 = getattr(rb, f"Conv_{2 * mi}"), getattr(rb, f"Conv_{2 * mi + 1}")
            h = conv_packed(_leaky(cur), c1.weight, c1.bias, d, g)
            h = conv_packed(_leaky(h), c2.weight, c2.bias, 1, g)
            cur = cur + h
        acc = cur if acc is None else acc + cur
    return acc / float(len(kernels))
