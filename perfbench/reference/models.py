"""The FlashSR sub-models in plain float32 PyTorch.

A frozen copy of the port's ``models/flashsr/{vae,ldm_unet,unet,
vocoder}.py`` module code with every kernel route taken out: attention
is ``layers.attention`` (exact softmax, float32), the HiFi-GAN MRF
stacks are their convolutions, and no layer has a compute dtype.
Submodule names follow the flax tree, so the JAX package's ``.npz``
trios and the converted upstream checkpoints load key for key.

* ``MelVAE``: the AudioLDM-family 2D conv VAE over the log-mel image
  (4x down/up-sampling, the mid ResBlock / single-head attention /
  ResBlock pair and the 1x1 (post_)quant convs where configured).
* ``LDMUNet``: the CompVis UNet of the upstream ``student_ldm.pth``.
* ``StudentUNet``: the shipped compact trios' FiLM UNet.
* ``SRVocoder``: the HiFi-GAN generator of ``sr_vocoder.pth``.
* ``SpectralVocoder``: the ConvNeXt iSTFT head of the istft trio.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import dsp
from .layers import (Conv1d, Conv2d, ConvTranspose1d, Dense, DenseGeneral, GroupNorm,
                     LayerNorm, attention, leaky_relu, upsample2x_nearest)
from .numerics import operand


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    base_channels: int = 64
    channel_mults: Sequence[int] = (1, 2, 4)
    latent_channels: int = 16
    num_res_blocks: int = 2
    groups: int = 32
    scaling_factor: float = 0.18215
    mid_attn: bool = True
    use_quant_conv: bool = True


@dataclasses.dataclass(frozen=True)
class LDMUNetConfig:
    in_channels: int = 32
    out_channels: int = 16
    model_channels: int = 128
    channel_mult: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (2, 4)
    num_heads: int = 8
    groups: int = 32


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 32
    out_channels: int = 16
    base_channels: int = 128
    channel_mults: Sequence[int] = (1, 2, 4)
    num_res_blocks: int = 2
    attn_levels: Sequence[int] = (2,)
    num_heads: int = 8
    time_dim: int = 512
    groups: int = 32


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    n_mels: int = 256
    upsample_initial: int = 512
    upsample_factors: Sequence[int] = (10, 8, 6)
    upsample_kernels: Sequence[int] = (20, 16, 12)
    resblock_kernels: Sequence[int] = (3, 7, 11)
    resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    channel_floor: int = 64
    kind: str = "hifigan"
    hidden: int = 256
    depth: int = 6
    mlp_ratio: int = 3
    istft_nfft: int = 1920
    phase_cond: bool = False
    exciter: bool = False


# ---- VAE ------------------------------------------------------------------

class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(groups, cin), cin)
        self.Conv_0 = Conv2d(cin, cout, 3)
        self.GroupNorm_1 = GroupNorm(min(groups, cout), cout)
        self.Conv_1 = Conv2d(cout, cout, 3)
        if cin != cout:
            self.Conv_2 = Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
        h = self.Conv_1(F.silu(self.GroupNorm_1(h)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class AttnBlock2D(nn.Module):
    """GroupNorm -> 1x1 q/k/v -> one head over the flattened grid ->
    1x1 proj_out, residual."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(groups, c), c)
        self.q = Conv2d(c, c, 1)
        self.k = Conv2d(c, c, 1)
        self.v = Conv2d(c, c, 1)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, m = x.shape
        h = self.GroupNorm_0(x)

        def tokens(t):
            return t.flatten(2).transpose(1, 2)[:, None]

        o = attention(tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h)))[:, 0]
        return x + self.proj_out(o.transpose(1, 2).reshape(b, c, f, m))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = self.cfg = cfg
        self.Conv_0 = Conv2d(1, c.base_channels, 3)
        ch_in, r = c.base_channels, 0
        for i, mult in enumerate(c.channel_mults):
            ch = c.base_channels * mult
            for _ in range(c.num_res_blocks):
                self.add_module(f"ResBlock_{r}", ResBlock(ch_in, ch, c.groups))
                ch_in, r = ch, r + 1
            if i < len(c.channel_mults) - 1:
                self.add_module(f"Conv_{i + 1}", Conv2d(ch, ch, 3, stride=2))
        if c.mid_attn:
            self.add_module(f"ResBlock_{r}", ResBlock(ch_in, ch_in, c.groups))
            self.AttnBlock2D_0 = AttnBlock2D(ch_in, c.groups)
            self.add_module(f"ResBlock_{r + 1}", ResBlock(ch_in, ch_in, c.groups))
        self.GroupNorm_0 = GroupNorm(c.groups, ch_in)
        self.add_module(f"Conv_{len(c.channel_mults)}",
                        Conv2d(ch_in, 2 * c.latent_channels, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = self.Conv_0(x)
        r = 0
        for i in range(len(c.channel_mults)):
            for _ in range(c.num_res_blocks):
                h = getattr(self, f"ResBlock_{r}")(h)
                r += 1
            if i < len(c.channel_mults) - 1:
                h = getattr(self, f"Conv_{i + 1}")(h)
        if c.mid_attn:
            h = getattr(self, f"ResBlock_{r}")(h)
            h = self.AttnBlock2D_0(h)
            h = getattr(self, f"ResBlock_{r + 1}")(h)
        h = F.silu(self.GroupNorm_0(h))
        return getattr(self, f"Conv_{len(c.channel_mults)}")(h)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c = self.cfg = cfg
        mults = tuple(reversed(c.channel_mults))
        ch_in = c.base_channels * mults[0]
        self.Conv_0 = Conv2d(c.latent_channels, ch_in, 3)
        r = 0
        if c.mid_attn:
            self.ResBlock_0 = ResBlock(ch_in, ch_in, c.groups)
            self.AttnBlock2D_0 = AttnBlock2D(ch_in, c.groups)
            self.ResBlock_1 = ResBlock(ch_in, ch_in, c.groups)
            r = 2
        for i, mult in enumerate(mults):
            ch = c.base_channels * mult
            for _ in range(c.num_res_blocks):
                self.add_module(f"ResBlock_{r}", ResBlock(ch_in, ch, c.groups))
                ch_in, r = ch, r + 1
            if i < len(mults) - 1:
                self.add_module(f"Conv_{i + 1}", Conv2d(ch, ch, 3))
        self.GroupNorm_0 = GroupNorm(c.groups, ch_in)
        self.add_module(f"Conv_{len(mults)}", Conv2d(ch_in, 1, 3))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = self.Conv_0(z)
        r = 0
        if c.mid_attn:
            h = self.ResBlock_1(self.AttnBlock2D_0(self.ResBlock_0(h)))
            r = 2
        for i in range(len(c.channel_mults)):
            for _ in range(c.num_res_blocks):
                h = getattr(self, f"ResBlock_{r}")(h)
                r += 1
            if i < len(c.channel_mults) - 1:
                h = getattr(self, f"Conv_{i + 1}")(upsample2x_nearest(h))
        h = F.silu(self.GroupNorm_0(h))
        return getattr(self, f"Conv_{len(c.channel_mults)}")(h)


class MelVAE(nn.Module):
    """Encode / decode log-mel images ``[B, F, M, 1]`` (NHWC outside)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            z = cfg.latent_channels
            self.quant_conv = Conv2d(2 * z, 2 * z, 1)
            self.post_quant_conv = Conv2d(z, z, 1)

    def encode(self, mel_img: torch.Tensor) -> torch.Tensor:
        h = self.encoder(mel_img.permute(0, 3, 1, 2))
        if self.cfg.use_quant_conv:
            h = self.quant_conv(h)
        mean = h.permute(0, 2, 3, 1).chunk(2, dim=-1)[0]
        return mean * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        z = (z / self.cfg.scaling_factor).permute(0, 3, 1, 2)
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z).permute(0, 2, 3, 1)


# ---- UNets ----------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding ``[B] -> [B, dim]`` (cos | sin)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class LDMResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int, groups: int):
        super().__init__()
        self.in_layers_0 = GroupNorm(min(groups, cin), cin)
        self.in_layers_2 = Conv2d(cin, cout, 3)
        self.emb_layers_1 = Dense(emb_dim, cout)
        self.out_layers_0 = GroupNorm(min(groups, cout), cout)
        self.out_layers_3 = Conv2d(cout, cout, 3)
        if cin != cout:
            self.skip_connection = Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers_2(F.silu(self.in_layers_0(x)))
        h = h + self.emb_layers_1(F.silu(emb))[:, :, None, None]
        h = self.out_layers_3(F.silu(self.out_layers_0(h)))
        if hasattr(self, "skip_connection"):
            x = self.skip_connection(x)
        return x + h


class LDMAttentionBlock(nn.Module):
    def __init__(self, c: int, num_heads: int, groups: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(min(groups, c), c)
        self.qkv = Dense(c, 3 * c)
        self.proj_out = Dense(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, m = x.shape
        n, hd = f * m, c // self.num_heads
        qkv = self.qkv(self.norm(x).flatten(2).transpose(1, 2))
        q, k, v = (t.reshape(b, n, self.num_heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        o = self.proj_out(attention(q, k, v).transpose(1, 2).reshape(b, n, c))
        return x + o.transpose(1, 2).reshape(b, c, f, m)


class LDMUNet(nn.Module):
    """``(z [B,F,M,Cin], t [B]) -> [B,F,M,Cout]``."""

    def __init__(self, cfg: LDMUNetConfig):
        super().__init__()
        self.cfg = c = cfg
        mc = c.model_channels
        emb = 4 * mc
        self.time_embed_0 = Dense(mc, emb)
        self.time_embed_2 = Dense(emb, emb)
        self.input_blocks_0_0 = Conv2d(c.in_channels, mc, 3)
        chans = [mc]
        ch, ds, idx = mc, 1, 1
        for level, mult in enumerate(c.channel_mult):
            for _ in range(c.num_res_blocks):
                self.add_module(f"input_blocks_{idx}_0", LDMResBlock(ch, mult * mc, emb, c.groups))
                ch = mult * mc
                if ds in c.attention_resolutions:
                    self.add_module(f"input_blocks_{idx}_1",
                                    LDMAttentionBlock(ch, c.num_heads, c.groups))
                chans.append(ch)
                idx += 1
            if level != len(c.channel_mult) - 1:
                self.add_module(f"input_blocks_{idx}_0_op", Conv2d(ch, ch, 3, stride=2))
                chans.append(ch)
                ds *= 2
                idx += 1
        self.middle_block_0 = LDMResBlock(ch, ch, emb, c.groups)
        self.middle_block_1 = LDMAttentionBlock(ch, c.num_heads, c.groups)
        self.middle_block_2 = LDMResBlock(ch, ch, emb, c.groups)
        idx = 0
        for level, mult in reversed(list(enumerate(c.channel_mult))):
            for i in range(c.num_res_blocks + 1):
                self.add_module(f"output_blocks_{idx}_0",
                                LDMResBlock(ch + chans.pop(), mult * mc, emb, c.groups))
                ch = mult * mc
                sub = 1
                if ds in c.attention_resolutions:
                    self.add_module(f"output_blocks_{idx}_{sub}",
                                    LDMAttentionBlock(ch, c.num_heads, c.groups))
                    sub += 1
                if level and i == c.num_res_blocks:
                    self.add_module(f"output_blocks_{idx}_{sub}_conv", Conv2d(ch, ch, 3))
                    ds //= 2
                idx += 1
        self.out_0 = GroupNorm(min(c.groups, ch), ch)
        self.out_2 = Conv2d(ch, c.out_channels, 3)

    def forward(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        mods = dict(self.named_children())
        emb = self.time_embed_2(F.silu(self.time_embed_0(timestep_embedding(t, c.model_channels))))
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
        h = self.middle_block_2(self.middle_block_1(self.middle_block_0(h, emb)), emb)
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
        return self.out_2(F.silu(self.out_0(h))).permute(0, 2, 3, 1)


class FiLMResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, time_dim: int, groups: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(groups, cin), cin)
        self.Conv_0 = Conv2d(cin, cout, 3)
        self.Dense_0 = Dense(time_dim, 2 * cout)
        self.GroupNorm_1 = GroupNorm(min(groups, cout), cout)
        self.Conv_1 = Conv2d(cout, cout, 3)
        if cin != cout:
            self.Conv_2 = Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
        scale, shift = self.Dense_0(F.silu(temb))[:, :, None, None].chunk(2, dim=1)
        h = self.Conv_1(F.silu(self.GroupNorm_1(h) * (1.0 + scale) + shift))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, c: int, num_heads: int):
        super().__init__()
        hd = c // num_heads
        self.query = DenseGeneral((c,), (num_heads, hd))
        self.key = DenseGeneral((c,), (num_heads, hd))
        self.value = DenseGeneral((c,), (num_heads, hd))
        self.out = DenseGeneral((num_heads, hd), (c,))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (m(x).transpose(1, 2) for m in (self.query, self.key, self.value))
        return self.out(attention(q, k, v).transpose(1, 2))


class SelfAttention2D(nn.Module):
    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(32, c), c)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(c, num_heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, m = x.shape
        h = self.MultiHeadDotProductAttention_0(self.GroupNorm_0(x).flatten(2).transpose(1, 2))
        return x + h.transpose(1, 2).reshape(b, c, f, m)


class StudentUNet(nn.Module):
    """``(z [B,F,M,Zin], t [B]) -> [B,F,M,Zout]``."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = c = cfg
        self.Dense_0 = Dense(c.time_dim, c.time_dim)
        self.Dense_1 = Dense(c.time_dim, c.time_dim)
        self.Conv_0 = Conv2d(c.in_channels, c.base_channels, 3)
        counts = {"res": 0, "attn": 0, "conv": 1}

        def res(cin, cout):
            self.add_module(f"FiLMResBlock_{counts['res']}",
                            FiLMResBlock(cin, cout, c.time_dim, c.groups))
            counts["res"] += 1

        def attn(ch):
            self.add_module(f"SelfAttention2D_{counts['attn']}", SelfAttention2D(ch, c.num_heads))
            counts["attn"] += 1

        def conv(cin, cout, stride=1):
            self.add_module(f"Conv_{counts['conv']}", Conv2d(cin, cout, 3, stride=stride))
            counts["conv"] += 1

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
        self.GroupNorm_0 = GroupNorm(c.groups, ch)
        conv(ch, c.out_channels)

    def forward(self, z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        temb = self.Dense_1(F.silu(self.Dense_0(timestep_embedding(t, c.time_dim))))
        counts = {"res": 0, "attn": 0, "conv": 1}

        def nxt(kind, prefix):
            counts[kind] += 1
            return getattr(self, f"{prefix}_{counts[kind] - 1}")

        h = self.Conv_0(z.permute(0, 3, 1, 2))
        skips = [h]
        for i in range(len(c.channel_mults)):
            for _ in range(c.num_res_blocks):
                h = nxt("res", "FiLMResBlock")(h, temb)
                if i in c.attn_levels:
                    h = nxt("attn", "SelfAttention2D")(h)
                skips.append(h)
            if i < len(c.channel_mults) - 1:
                h = nxt("conv", "Conv")(h)
                skips.append(h)
        h = nxt("res", "FiLMResBlock")(h, temb)
        h = nxt("attn", "SelfAttention2D")(h)
        h = nxt("res", "FiLMResBlock")(h, temb)
        for i in reversed(range(len(c.channel_mults))):
            for _ in range(c.num_res_blocks + 1):
                h = nxt("res", "FiLMResBlock")(torch.cat([h, skips.pop()], dim=1), temb)
                if i in c.attn_levels:
                    h = nxt("attn", "SelfAttention2D")(h)
            if i > 0:
                h = nxt("conv", "Conv")(upsample2x_nearest(h))
        h = F.silu(self.GroupNorm_0(h))
        return nxt("conv", "Conv")(h).permute(0, 2, 3, 1)


# ---- vocoders -------------------------------------------------------------

class ResBlock1D(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations: Sequence[int]):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            self.add_module(f"Conv_{2 * i}", Conv1d(channels, channels, kernel, d))
            self.add_module(f"Conv_{2 * i + 1}", Conv1d(channels, channels, kernel, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dilations)):
            h = getattr(self, f"Conv_{2 * i}")(leaky_relu(x))
            x = x + getattr(self, f"Conv_{2 * i + 1}")(leaky_relu(h))
        return x


class MRF(nn.Module):
    def __init__(self, channels: int, kernels: Sequence[int],
                 dilations: Sequence[Sequence[int]]):
        super().__init__()
        self.n = len(kernels)
        for j, (k, ds) in enumerate(zip(kernels, dilations)):
            self.add_module(f"ResBlock1D_{j}", ResBlock1D(channels, k, ds))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sum(getattr(self, f"ResBlock1D_{j}")(x) for j in range(self.n)) / self.n


class SRVocoder(nn.Module):
    """HiFi-GAN: ``mel [B, F, n_mels] -> wave [B, F * prod(factors)]``."""

    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        self.cfg = c = cfg
        self.Conv_0 = Conv1d(c.n_mels, c.upsample_initial, 7)
        ch = c.upsample_initial
        for i, (f, k) in enumerate(zip(c.upsample_factors, c.upsample_kernels)):
            out = max(ch // 2, c.channel_floor)
            self.add_module(f"ConvTranspose_{i}", ConvTranspose1d(ch, out, k, f))
            self.add_module(f"MRF_{i}", MRF(out, c.resblock_kernels, c.resblock_dilations))
            ch = out
        self.Conv_1 = Conv1d(ch, 1, 7)

    def forward(self, mel: torch.Tensor, ref: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.Conv_0(mel.transpose(1, 2))
        for i in range(len(self.cfg.upsample_factors)):
            h = getattr(self, f"MRF_{i}")(getattr(self, f"ConvTranspose_{i}")(leaky_relu(h)))
        return torch.tanh(self.Conv_1(leaky_relu(h)))[:, 0]


class ConvNeXtBlock1D(nn.Module):
    """Depthwise k = 7 along frames, LayerNorm, tanh-GELU MLP, residual."""

    def __init__(self, dim: int, mlp: int):
        super().__init__()
        self.dw_kernel = nn.Parameter(torch.zeros(7, dim))
        self.dw_bias = nn.Parameter(torch.zeros(dim))
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, mlp)
        self.Dense_1 = Dense(mlp, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = x.shape[1]
        xp = F.pad(operand(x), (0, 0, 3, 3))
        w = operand(self.dw_kernel)
        h = self.dw_bias + sum(xp[:, j: j + f, :] * w[j] for j in range(7))
        h = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_0(h)), approximate="tanh"))
        return x + h


def _phasor(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    m = torch.sqrt(re * re + im * im)
    inv = 1.0 / (m + 1e-6)
    return re * inv, im * inv, m


class SpectralVocoder(nn.Module):
    """ConvNeXt backbone predicting the log-magnitude and phase of a
    1920-point STFT, inverted densely; with ``phase_cond`` it sees the
    input chunk's STFT (and with ``exciter`` that of its square and cube)
    through gated phase candidates."""

    def __init__(self, cfg: VocoderConfig):
        super().__init__()
        self.cfg = c = cfg
        nbins = c.istft_nfft // 2 + 1
        self.Conv_0 = Conv1d(c.n_mels, c.hidden, 7)
        self.LayerNorm_0 = LayerNorm(c.hidden)
        if c.phase_cond:
            self.phase_in = Dense((13 if c.exciter else 7) * nbins, c.hidden)
        for i in range(c.depth):
            self.add_module(f"ConvNeXtBlock1D_{i}",
                            ConvNeXtBlock1D(c.hidden, c.hidden * c.mlp_ratio))
        self.LayerNorm_1 = LayerNorm(c.hidden)
        self.Dense_0 = Dense(c.hidden, nbins)
        self.Dense_1 = Dense(c.hidden, 2 * nbins)
        if c.phase_cond:
            self.phase_gates = Dense(c.hidden, (10 if c.exciter else 6) * nbins)
            self.mag_gate = Dense(c.hidden, nbins)

    def _features(self, ref: torch.Tensor, f: int):
        n_fft, hop = self.cfg.istft_nfft, 480
        nbins = n_fft // 2 + 1

        def stft(sig):
            return dsp.stft_conv(dsp.reflect_pad(sig, n_fft // 2), n_fft, hop)

        def cut(a):
            a = a[:, :f]
            return F.pad(a, (0, 0, 0, f - a.shape[1]))

        cos, sin, m = _phasor(*stft(ref))
        idx2 = torch.arange(nbins, device=ref.device) // 2
        idx3 = torch.arange(nbins, device=ref.device) // 3
        c2 = cos * cos - sin * sin
        s2 = 2.0 * cos * sin
        c3 = c2 * cos - s2 * sin
        s3 = s2 * cos + c2 * sin
        feats = [cos, sin, torch.log(m + 1e-5), c2[..., idx2], s2[..., idx2],
                 c3[..., idx3], s3[..., idx3]]
        if self.cfg.exciter:
            xn = ref * torch.rsqrt(torch.mean(ref * ref, dim=-1, keepdim=True) + 1e-12)
            e2 = xn * xn
            for e in (e2, e2 * xn):
                ec, es, em = _phasor(*stft(e))
                feats += [ec, es, torch.log(em + 1e-5)]
        return [cut(a) for a in feats]

    def forward(self, mel: torch.Tensor, ref: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        n_fft, hop = c.istft_nfft, 480
        nbins = n_fft // 2 + 1
        f = mel.shape[-2]
        x = self.LayerNorm_0(self.Conv_0(mel.transpose(1, 2)).transpose(1, 2))
        if c.phase_cond:
            feats = self._features(ref, f)
            x = x + self.phase_in(torch.cat(feats, dim=-1))
        for i in range(c.depth):
            x = getattr(self, f"ConvNeXtBlock1D_{i}")(x)
        x = self.LayerNorm_1(x)
        logmag = self.Dense_0(x)
        ph = self.Dense_1(x)
        pr, pi = ph[..., :nbins], ph[..., nbins:]
        if c.phase_cond:
            cos, sin, logm_in, c2h, s2h, c3h, s3h = feats[:7]
            gs = self.phase_gates(x).split(nbins, dim=-1)
            g1r, g1i, g2r, g2i, g3r, g3i = gs[:6]
            pr = (pr + g1r * cos - g1i * sin + g2r * c2h - g2i * s2h
                  + g3r * c3h - g3i * s3h)
            pi = (pi + g1r * sin + g1i * cos + g2r * s2h + g2i * c2h
                  + g3r * s3h + g3i * c3h)
            if c.exciter:
                ce2, se2, _, ce3, se3, _ = feats[7:]
                g4r, g4i, g5r, g5i = gs[6:]
                pr = pr + g4r * ce2 - g4i * se2 + g5r * ce3 - g5i * se3
                pi = pi + g4r * se2 + g4i * ce2 + g5r * se3 + g5i * ce3
            logmag = logmag + torch.sigmoid(self.mag_gate(x)) * logm_in
        inv = torch.rsqrt(pr * pr + pi * pi + 1e-6)
        mag = torch.exp(torch.clamp(logmag, -30.0, 9.0))
        y = dsp.istft_dense(mag * pr * inv, mag * pi * inv, n_fft, hop)
        return y[..., n_fft // 2: n_fft // 2 + f * hop]


def build_vocoder(cfg: VocoderConfig) -> nn.Module:
    return SpectralVocoder(cfg) if cfg.kind == "istft" else SRVocoder(cfg)
