"""One-step student UNet of the shipped compact trios (``StudentUNet``).

Counterpart of ``egregora_tpu/models/flashsr/unet.py``: FiLM ResBlocks
(a sinusoidal step embedding through two float32 dense layers sets a
per-channel scale and shift), self-attention at the levels of
``attn_levels`` and once in the middle, stride-2 downsampling, nearest-2x
upsampling, every down-path output kept as a skip.  The shipped trios
(``attn_levels=()``, 4 heads at 128 channels) attend once, in the middle:
N = 512 latent tokens, D = 32.  That block is flax's
``MultiHeadDotProductAttention`` in the JAX package; here its heads go
through ``ops.attention.mha``, the ``attn_rows`` kernel on the card.
The two differ in rounding only: flax scales q before the product and,
in bf16, softmaxes in bf16; ``attn_rows`` scales the f32 scores and
keeps them in f32.  ``forward`` takes and returns NHWC; inside, tensors
are NCHW.  Submodule names follow the flax tree.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import mha
from ...ops.resize import upsample2x_nearest
from .layers import Conv2d, Dense, DenseGeneral, GroupNorm
from .ldm_unet import timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 32           # z_noise (16) ++ z_lr cond (16)
    out_channels: int = 16
    base_channels: int = 128
    channel_mults: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_levels: Sequence[int] = (2,)
    num_heads: int = 8
    time_dim: int = 512
    groups: int = 32
    dtype: torch.dtype = torch.bfloat16


class FiLMResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, time_dim: int, groups: int,
                 dtype: torch.dtype):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(groups, cin), cin, dtype)
        self.Conv_0 = Conv2d(cin, cout, 3, dtype=dtype)
        self.Dense_0 = Dense(time_dim, 2 * cout, dtype=torch.float32)
        self.GroupNorm_1 = GroupNorm(min(groups, cout), cout, dtype)
        self.Conv_1 = Conv2d(cout, cout, 3, dtype=dtype)
        if cin != cout:
            self.Conv_2 = Conv2d(cin, cout, 1, dtype=dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
        scale, shift = self.Dense_0(F.silu(temb))[:, :, None, None].to(self.dtype).chunk(2, dim=1)
        h = self.GroupNorm_1(h) * (1.0 + scale) + shift
        h = self.Conv_1(F.silu(h))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, qkv and
    out features = C): ``query/key/value`` ``[C, H, hd]``, ``out``
    ``[H, hd, C]``."""

    def __init__(self, c: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        hd = c // num_heads
        self.query = DenseGeneral((c,), (num_heads, hd), dtype)
        self.key = DenseGeneral((c,), (num_heads, hd), dtype)
        self.value = DenseGeneral((c,), (num_heads, hd), dtype)
        self.out = DenseGeneral((num_heads, hd), (c,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, N, C] -> [B, N, C]``."""
        q, k, v = (m(x).transpose(1, 2) for m in (self.query, self.key, self.value))
        return self.out(mha(q, k, v).transpose(1, 2))


class SelfAttention2D(nn.Module):
    def __init__(self, c: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(32, c), c, dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(c, num_heads, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, m = x.shape
        h = self.GroupNorm_0(x).flatten(2).transpose(1, 2)          # [B, N, C]
        h = self.MultiHeadDotProductAttention_0(h)
        return x + h.transpose(1, 2).reshape(b, c, f, m)


class StudentUNet(nn.Module):
    """``(z_t [B,F,M,Zin], t [B]) -> prediction [B,F,M,Zout]`` float32."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        dt = c.dtype
        self.Dense_0 = Dense(c.time_dim, c.time_dim, dtype=torch.float32)
        self.Dense_1 = Dense(c.time_dim, c.time_dim, dtype=torch.float32)
        self.Conv_0 = Conv2d(c.in_channels, c.base_channels, 3, dtype=dt)
        n_res = n_attn = 0
        n_conv = 1

        def res(cin, cout):
            nonlocal n_res
            self.add_module(f"FiLMResBlock_{n_res}",
                            FiLMResBlock(cin, cout, c.time_dim, c.groups, dt))
            n_res += 1

        def attn(ch):
            nonlocal n_attn
            self.add_module(f"SelfAttention2D_{n_attn}", SelfAttention2D(ch, c.num_heads, dt))
            n_attn += 1

        def conv(cin, cout, stride=1):
            nonlocal n_conv
            self.add_module(f"Conv_{n_conv}", Conv2d(cin, cout, 3, stride=stride, dtype=dt))
            n_conv += 1

        # the flax tree's creation order, which numbers the submodules
        ch = c.base_channels
        skips = [ch]
        for i, mult in enumerate(c.channel_mults):
            for _ in range(c.num_res_blocks):
                res(ch, c.base_channels * mult)
                ch = c.base_channels * mult
                if i in c.attn_levels:
                    attn(ch)
                skips.append(ch)
            if i < len(c.channel_mults) - 1:
                conv(ch, ch, stride=2)
                skips.append(ch)
        mid = c.base_channels * c.channel_mults[-1]
        res(ch, mid)
        attn(mid)
        res(mid, mid)
        ch = mid
        for i, mult in reversed(list(enumerate(c.channel_mults))):
            for _ in range(c.num_res_blocks + 1):
                res(ch + skips.pop(), c.base_channels * mult)
                ch = c.base_channels * mult
                if i in c.attn_levels:
                    attn(ch)
            if i > 0:
                conv(ch, ch)
        self.GroupNorm_0 = GroupNorm(c.groups, ch, dt)
        self.add_module(f"Conv_{n_conv}", Conv2d(ch, c.out_channels, 3, dtype=dt))

    def forward(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        temb = timestep_embedding(t, c.time_dim)
        temb = self.Dense_1(F.silu(self.Dense_0(temb)))
        h = self.Conv_0(z.permute(0, 3, 1, 2))
        skips = [h]
        n_res = n_attn = 0
        n_conv = 1

        def res(h):
            nonlocal n_res
            n_res += 1
            return getattr(self, f"FiLMResBlock_{n_res - 1}")(h, temb)

        def attn(h):
            nonlocal n_attn
            n_attn += 1
            return getattr(self, f"SelfAttention2D_{n_attn - 1}")(h)

        def conv(h):
            nonlocal n_conv
            n_conv += 1
            return getattr(self, f"Conv_{n_conv - 1}")(h)

        for i in range(len(c.channel_mults)):
            for _ in range(c.num_res_blocks):
                h = res(h)
                if i in c.attn_levels:
                    h = attn(h)
                skips.append(h)
            if i < len(c.channel_mults) - 1:
                h = conv(h)
                skips.append(h)
        h = res(attn(res(h)))
        for i in reversed(range(len(c.channel_mults))):
            for _ in range(c.num_res_blocks + 1):
                h = res(torch.cat([h, skips.pop()], dim=1))
                if i in c.attn_levels:
                    h = attn(h)
            if i > 0:
                h = conv(upsample2x_nearest(h))
        h = F.silu(self.GroupNorm_0(h))
        return conv(h).float().permute(0, 2, 3, 1)
