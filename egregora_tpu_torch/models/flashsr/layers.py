"""Layers with flax ``linen`` semantics on PyTorch's NCHW / NCW layouts.

The FlashSR models of the JAX package are built from ``nn.Conv``,
``nn.ConvTranspose``, ``nn.Dense`` and ``nn.GroupNorm``.  Three of their
defaults differ from torch's and are kept here:

* 'SAME' padding puts the odd pad after the signal: a stride-2 3x3 conv
  pads (0, 1), where torch's ``padding=1`` pads (1, 1);
* ``ConvTranspose`` (``transpose_kernel=False``) correlates the
  zero-stuffed input with the kernel as stored; the port stores the
  kernel flipped and channel-swapped, the layout ``conv_transpose1d``
  takes, and crops to flax's 'SAME' window (``length * stride``);
* ``GroupNorm`` and ``LayerNorm`` use eps 1e-6 and take their statistics
  in float32 whatever the compute dtype.

Parameters are float32; each layer computes in its ``dtype`` (bf16 on the
card by default), as flax's ``dtype`` argument does.  Parameter names
follow the flax tree (``weight`` for ``kernel`` and ``scale``), so
``utils.weights.params_from_jax`` maps a flax tree key for key.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

GN_EPS = 1e-6


def same_pads(size: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding ``(before, after)`` for one spatial axis."""
    out = -(-size // stride)
    need = max(0, (out - 1) * stride + (k - 1) * dilation + 1 - size)
    return need // 2, need - need // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s))`` on NCHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride, self.dtype = k, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        if self.stride == 1 and self.k % 2:
            return F.conv2d(x, w, b, padding=self.k // 2)
        ph = same_pads(x.shape[-2], self.k, self.stride)
        pw = same_pads(x.shape[-1], self.k, self.stride)
        return F.conv2d(F.pad(x, pw + ph), w, b, stride=self.stride)


class Conv1d(nn.Module):
    """flax ``nn.Conv(features, (k,), strides=(s,), kernel_dilation=(d,))``
    on NCW."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1,
                 dtype: torch.dtype = torch.bfloat16, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.dilation, self.stride, self.dtype = k, dilation, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        lo, hi = same_pads(x.shape[-1], self.k, self.stride, self.dilation)
        if lo == hi:
            return F.conv1d(x, w, b, self.stride, lo, self.dilation)
        return F.conv1d(F.pad(x, (lo, hi)), w, b, self.stride, 0, self.dilation)


def conv_transpose_pads(k: int, stride: int) -> Tuple[int, int]:
    """``lax.conv_transpose`` 'SAME' padding of the zero-stuffed input."""
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTranspose1d(nn.Module):
    """flax ``nn.ConvTranspose(features, (k,), strides=(s,))`` ('SAME',
    ``transpose_kernel=False``) on NCW: ``[B, Ci, T] -> [B, Co, T*s]``.

    ``weight`` is ``[Ci, Co, k]``, the flax kernel ``[k, Ci, Co]`` flipped
    along k (``params_from_jax`` does the flip)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride, self.dtype = k, stride, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[-1]
        y = F.conv_transpose1d(x.to(self.dtype), self.weight.to(self.dtype),
                               stride=self.stride)
        # y[o + p] is flax's output o, with p = k - 1 - pad_a
        p = self.k - 1 - conv_transpose_pads(self.k, self.stride)[0]
        n = t * self.stride
        lo, hi = max(p, 0), min(p + n, y.shape[-1])
        y = F.pad(y[..., lo:hi], (lo - p, p + n - hi))
        return y + self.bias.to(self.dtype)[:, None]


class Dense(nn.Module):
    """flax ``nn.Dense`` on the last axis: ``weight`` is ``[out, in]``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` from the last ``len(in_shape)`` axes to
    ``out_shape``; ``weight`` keeps the flax kernel's layout
    ``in_shape + out_shape`` (the heads of flax's multi-head attention:
    ``query`` ``[C, H, hd]``, ``out`` ``[H, hd, C]``)."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.weight = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        n_in = self.weight.shape[:len(self.in_shape)].numel()
        w = self.weight.reshape(n_in, -1).t().to(self.dtype)
        y = F.linear(x.reshape(lead + (n_in,)).to(self.dtype), w,
                     self.bias.reshape(-1).to(self.dtype))
        return y.reshape(lead + self.out_shape)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` on channel axis 1: float32
    statistics, eps 1e-6, output in ``dtype``."""

    def __init__(self, groups: int, channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.dtype = groups, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias,
                            GN_EPS).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` on the last axis: float32 statistics, eps
    1e-6, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            GN_EPS).to(self.dtype)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def seeded_init_(module: nn.Module, gen: torch.Generator) -> None:
    """Shape-based random init in place, flax-like scales: lecun-normal
    weights (std ``fan_in**-0.5``), zero biases, unit norm scales.
    Drawn on the CPU from ``gen``, so a seed gives the same weights on
    every device."""
    for mod in module.modules():
        if isinstance(mod, (GroupNorm, LayerNorm)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif hasattr(mod, "dw_kernel"):      # depthwise taps [k, D]
            with torch.no_grad():
                w = mod.dw_kernel
                w.copy_((torch.randn(w.shape, generator=gen) * w.shape[0] ** -0.5).to(w.device))
        elif isinstance(mod, (Conv2d, Conv1d, ConvTranspose1d, Dense, DenseGeneral)):
            w = mod.weight
            if isinstance(mod, DenseGeneral):
                fan_in = mod.weight.shape[:len(mod.in_shape)].numel()
            else:
                fan_in = w.numel() // w.shape[1 if isinstance(mod, ConvTranspose1d) else 0]
            vals = torch.randn(w.shape, generator=gen) * fan_in ** -0.5
            with torch.no_grad():
                w.copy_(vals.to(w.device))
                mod.bias.zero_()
