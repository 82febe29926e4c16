"""Layers with flax ``linen`` semantics on PyTorch's NCHW / NCW layouts,
in float32.

A frozen copy of the port's ``models/flashsr/layers.py`` with its
compute dtype removed: every layer computes in float32, and its
products take their operands through ``numerics.operand`` (float32, or
the fp8 control).  The flax conventions are kept: 'SAME' padding puts
the odd pad after the signal; ``ConvTranspose`` correlates the
zero-stuffed input with the kernel as stored, kept here flipped and
channel-swapped, cropped to flax's 'SAME' window; ``GroupNorm`` and
``LayerNorm`` use eps 1e-6.  Parameter names follow the flax tree
(``weight`` for ``kernel`` and ``scale``), so ``convert.load_flax`` maps
a flax tree key for key.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .numerics import operand

GN_EPS = 1e-6


def same_pads(size: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding ``(before, after)`` for one spatial axis."""
    out = -(-size // stride)
    need = max(0, (out - 1) * stride + (k - 1) * dilation + 1 - size)
    return need // 2, need - need // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides=(s, s))`` on NCHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride = k, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = operand(x), operand(self.weight)
        ph = same_pads(x.shape[-2], self.k, self.stride)
        pw = same_pads(x.shape[-1], self.k, self.stride)
        return F.conv2d(F.pad(x, pw + ph), w, self.bias, stride=self.stride)


class Conv1d(nn.Module):
    """flax ``nn.Conv(features, (k,), kernel_dilation=(d,))`` on NCW."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.dilation = k, dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = operand(x), operand(self.weight)
        lo, hi = same_pads(x.shape[-1], self.k, 1, self.dilation)
        return F.conv1d(F.pad(x, (lo, hi)), w, self.bias, 1, 0, self.dilation)


def conv_transpose_pads(k: int, stride: int) -> Tuple[int, int]:
    """``lax.conv_transpose`` 'SAME' padding of the zero-stuffed input."""
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTranspose1d(nn.Module):
    """flax ``nn.ConvTranspose(features, (k,), strides=(s,))`` ('SAME',
    ``transpose_kernel=False``) on NCW: ``[B, Ci, T] -> [B, Co, T*s]``.
    ``weight`` is ``[Ci, Co, k]``, the flax kernel ``[k, Ci, Co]`` flipped
    along k."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.k, self.stride = k, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[-1]
        y = F.conv_transpose1d(operand(x), operand(self.weight), stride=self.stride)
        p = self.k - 1 - conv_transpose_pads(self.k, self.stride)[0]
        n = t * self.stride
        lo, hi = max(p, 0), min(p + n, y.shape[-1])
        y = F.pad(y[..., lo:hi], (lo - p, p + n - hi))
        return y + self.bias[:, None]


class Dense(nn.Module):
    """flax ``nn.Dense`` on the last axis: ``weight`` is ``[out, in]``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(operand(x), operand(self.weight), self.bias)


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` from the last ``len(in_shape)`` axes to
    ``out_shape``; ``weight`` keeps the flax layout ``in_shape + out_shape``."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...]):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.weight = nn.Parameter(torch.empty(self.in_shape + self.out_shape))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:x.dim() - len(self.in_shape)]
        n_in = self.weight.shape[:len(self.in_shape)].numel()
        w = self.weight.reshape(n_in, -1).t()
        y = F.linear(operand(x.reshape(lead + (n_in,))), operand(w), self.bias.reshape(-1))
        return y.reshape(lead + self.out_shape)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` on channel axis 1, eps 1e-6."""

    def __init__(self, groups: int, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.weight, self.bias, GN_EPS)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` on the last axis, eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, GN_EPS)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


def upsample2x_nearest(h: torch.Tensor) -> torch.Tensor:
    """``[B, C, F, M] -> [B, C, 2F, 2M]`` by pixel duplication."""
    b, c, f, m = h.shape
    return h[:, :, :, None, :, None].expand(b, c, f, 2, m, 2).reshape(b, c, 2 * f, 2 * m)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """Exact softmax attention ``[B, H, N, D] -> [B, H, N, D]`` in
    float32, ``block`` query rows at a time (the scores of a block are
    ``[B, H, block, N]``).  In the fp8 mode q, k, v and the softmax
    weights are the rounded operands."""
    d = q.shape[-1]
    qf, kt, vf = operand(q), operand(k).transpose(-1, -2), operand(v)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for i in range(0, q.shape[-2], block):
        s = torch.matmul(qf[..., i:i + block, :], kt) * d ** -0.5
        w = operand(torch.softmax(s, dim=-1))
        out[..., i:i + block, :] = torch.matmul(w, vf)
    return out
