"""Latent-diffusion UNetModel (CompVis lineage, FlashSR's
``student_ldm.pth`` layout) in PyTorch.

Counterpart of ``egregora_tpu/models/flashsr/ldm_unet.py``: ResBlocks
with a time-embedding bias, multi-head ``LDMAttentionBlock``s at the
downsample factors of ``attention_resolutions`` (full config: 8 heads at
ds=2, N=2048, D=32, and ds=4, N=512, D=64; 11 blocks per forward, all
through ``ops.attention.mha``), nearest-2x upsampling, every input
block's output kept as a skip.  ``forward`` takes and returns NHWC;
inside, tensors are NCHW.  Submodule names follow the flax tree
(``input_blocks_{i}_{j}``, ``middle_block_{j}``, ``output_blocks_{i}_{j}``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import mha
from ...ops.resize import upsample2x_nearest
from .layers import Conv2d, Dense, GroupNorm


@dataclasses.dataclass(frozen=True)
class LDMUNetConfig:
    in_channels: int = 32           # z_noise (16) ++ z_lr cond (16)
    out_channels: int = 16
    model_channels: int = 128
    channel_mult: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (2, 4)
    num_heads: int = 8
    groups: int = 32
    dtype: torch.dtype = torch.bfloat16


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding ``[B] -> [B, dim]`` (cos | sin, DDPM convention)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class LDMResBlock(nn.Module):
    """in_layers (GN, silu, conv) + emb_layers (silu, linear) added per
    channel + out_layers (GN, silu, conv), 1x1 skip when channels change."""

    def __init__(self, cin: int, cout: int, emb_dim: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.in_layers_0 = GroupNorm(min(groups, cin), cin, dtype)
        self.in_layers_2 = Conv2d(cin, cout, 3, dtype=dtype)
        self.emb_layers_1 = Dense(emb_dim, cout, dtype=torch.float32)
        self.out_layers_0 = GroupNorm(min(groups, cout), cout, dtype)
        self.out_layers_3 = Conv2d(cout, cout, 3, dtype=dtype)
        if cin != cout:
            self.skip_connection = Conv2d(cin, cout, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers_2(F.silu(self.in_layers_0(x)))
        e = self.emb_layers_1(F.silu(emb))
        h = h + e[:, :, None, None].to(h.dtype)
        h = self.out_layers_3(F.silu(self.out_layers_0(h)))
        if hasattr(self, "skip_connection"):
            x = self.skip_connection(x)
        return x + h


class LDMAttentionBlock(nn.Module):
    """GN -> fused qkv (dense) -> multi-head attention over the flattened
    grid -> proj_out, residual."""

    def __init__(self, c: int, num_heads: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(min(groups, c), c, dtype)
        self.qkv = Dense(c, 3 * c, dtype=dtype)
        self.proj_out = Dense(c, c, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, m = x.shape
        n, hd = f * m, c // self.num_heads
        qkv = self.qkv(self.norm(x).flatten(2).transpose(1, 2))     # [B, N, 3C]
        q, k, v = (t.reshape(b, n, self.num_heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))                    # [B, H, N, hd]
        o = mha(q, k, v).transpose(1, 2).reshape(b, n, c)
        o = self.proj_out(o)
        return x + o.transpose(1, 2).reshape(b, c, f, m)


class LDMUNet(nn.Module):
    """``(z [B,F,M,Cin], t [B]) -> [B,F,M,Cout]`` float32."""

    def __init__(self, cfg: LDMUNetConfig = LDMUNetConfig()):
        super().__init__()
        self.cfg = c = cfg
        dt, mc = cfg.dtype, cfg.model_channels
        emb = 4 * mc
        self.time_embed_0 = Dense(mc, emb, dtype=torch.float32)
        self.time_embed_2 = Dense(emb, emb, dtype=torch.float32)
        self.input_blocks_0_0 = Conv2d(c.in_channels, mc, 3, dtype=dt)

        def res(name, cin, cout):
            self.add_module(name, LDMResBlock(cin, cout, emb, c.groups, dt))

        def attn(name, ch):
            self.add_module(name, LDMAttentionBlock(ch, c.num_heads, c.groups, dt))

        chans = [mc]
        ch, ds, idx = mc, 1, 1
        for level, mult in enumerate(c.channel_mult):
            for _ in range(c.num_res_blocks):
                res(f"input_blocks_{idx}_0", ch, mult * mc)
                ch = mult * mc
                if ds in c.attention_resolutions:
                    attn(f"input_blocks_{idx}_1", ch)
                chans.append(ch)
                idx += 1
            if level != len(c.channel_mult) - 1:
                self.add_module(f"input_blocks_{idx}_0_op", Conv2d(ch, ch, 3, stride=2, dtype=dt))
                chans.append(ch)
                ds *= 2
                idx += 1
        res("middle_block_0", ch, ch)
        attn("middle_block_1", ch)
        res("middle_block_2", ch, ch)
        idx = 0
        for level, mult in reversed(list(enumerate(c.channel_mult))):
            for i in range(c.num_res_blocks + 1):
                res(f"output_blocks_{idx}_0", ch + chans.pop(), mult * mc)
                ch = mult * mc
                sub = 1
                if ds in c.attention_resolutions:
                    attn(f"output_blocks_{idx}_{sub}", ch)
                    sub += 1
                if level and i == c.num_res_blocks:
                    self.add_module(f"output_blocks_{idx}_{sub}_conv", Conv2d(ch, ch, 3, dtype=dt))
                    ds //= 2
                idx += 1
        self.out_0 = GroupNorm(min(c.groups, ch), ch, dt)
        self.out_2 = Conv2d(ch, c.out_channels, 3, dtype=dt)

    def forward(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        mods = dict(self.named_children())
        emb = self.time_embed_0(timestep_embedding(t, c.model_channels))
        emb = self.time_embed_2(F.silu(emb))

        h = self.input_blocks_0_0(z.permute(0, 3, 1, 2))
        hs = [h]
        ds, idx = 1, 1
        for level, _ in enumerate(c.channel_mult):
            for _ in range(c.num_res_blocks):
                h = mods[f"input_blocks_{idx}_0"](h, emb)
                if ds in c.attention_resolutions:
                    h = mods[f"input_blocks_{idx}_1"](h)
                hs.append(h)
                idx += 1
            if level != len(c.channel_mult) - 1:
                h = mods[f"input_blocks_{idx}_0_op"](h)
                hs.append(h)
                ds *= 2
                idx += 1

        h = self.middle_block_0(h, emb)
        h = self.middle_block_1(h)
        h = self.middle_block_2(h, emb)

        idx = 0
        for level, _ in reversed(list(enumerate(c.channel_mult))):
            for i in range(c.num_res_blocks + 1):
                h = mods[f"output_blocks_{idx}_0"](torch.cat([h, hs.pop()], dim=1), emb)
                sub = 1
                if ds in c.attention_resolutions:
                    h = mods[f"output_blocks_{idx}_{sub}"](h)
                    sub += 1
                if level and i == c.num_res_blocks:
                    h = mods[f"output_blocks_{idx}_{sub}_conv"](upsample2x_nearest(h))
                    ds //= 2
                idx += 1
        h = self.out_2(F.silu(self.out_0(h)))
        return h.float().permute(0, 2, 3, 1)
