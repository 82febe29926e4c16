"""Mel-spectrogram VAE (FlashSR's ``vae.pth`` layout) in PyTorch.

Counterpart of ``egregora_tpu/models/flashsr/vae.py`` at the full
config: an AudioLDM-family 2D conv VAE over the log-mel image with 4x
spatial downsampling, the upstream mid ResBlock/Attn/ResBlock pair in
both coders and the 1x1 (post_)quant convs.  The mid ``AttnBlock2D``
(one head over the flattened token grid: N = 8192 a chunk, D = 256 at
the full config, 512 at the published checkpoints' geometry) runs
through ``ops.attention.mha``, i.e. the ``attn_rows`` kernel on the
card.  Public functions take and return NHWC, as the JAX
package's do; inside, tensors are NCHW.  Submodule names follow the
flax tree.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import mha
from ...ops.resize import upsample2x_nearest
from .layers import Conv2d, GroupNorm


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    base_channels: int = 64
    channel_mults: Sequence[int] = (1, 2, 4)   # 2 downsamples => 4x
    latent_channels: int = 16
    num_res_blocks: int = 2
    groups: int = 32
    scaling_factor: float = 0.18215
    mid_attn: bool = True
    use_quant_conv: bool = True
    dtype: torch.dtype = torch.bfloat16


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(groups, cin), cin, dtype)
        self.Conv_0 = Conv2d(cin, cout, 3, dtype=dtype)
        self.GroupNorm_1 = GroupNorm(min(groups, cout), cout, dtype)
        self.Conv_1 = Conv2d(cout, cout, 3, dtype=dtype)
        if cin != cout:
            self.Conv_2 = Conv2d(cin, cout, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(F.silu(self.GroupNorm_0(x)))
        h = self.Conv_1(F.silu(self.GroupNorm_1(h)))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2(x)
        return x + h


class AttnBlock2D(nn.Module):
    """Upstream AutoencoderKL ``mid.attn_1``: GroupNorm -> 1x1 q/k/v ->
    single-head attention over the flattened grid -> 1x1 proj_out,
    residual."""

    def __init__(self, c: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(min(groups, c), c, dtype)
        self.q = Conv2d(c, c, 1, dtype=dtype)
        self.k = Conv2d(c, c, 1, dtype=dtype)
        self.v = Conv2d(c, c, 1, dtype=dtype)
        self.proj_out = Conv2d(c, c, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, f, m = x.shape
        h = self.GroupNorm_0(x)

        def tokens(t):   # [B, C, F, M] -> [B, 1, F*M, C]
            return t.flatten(2).transpose(1, 2)[:, None]

        o = mha(tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h)))[:, 0]
        o = o.transpose(1, 2).reshape(b, c, f, m)
        return x + self.proj_out(o)


class Encoder(nn.Module):
    """``[B, 1, F, M] -> moments [B, 2Z, F/4, M/4]``."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = cfg
        self.Conv_0 = Conv2d(1, c.base_channels, 3, dtype=dt)
        ch_in, r = c.base_channels, 0
        for i, mult in enumerate(c.channel_mults):
            ch = c.base_channels * mult
            for _ in range(c.num_res_blocks):
                self.add_module(f"ResBlock_{r}", ResBlock(ch_in, ch, c.groups, dt))
                ch_in, r = ch, r + 1
            if i < len(c.channel_mults) - 1:
                self.add_module(f"Conv_{i + 1}", Conv2d(ch, ch, 3, stride=2, dtype=dt))
        if c.mid_attn:
            self.add_module(f"ResBlock_{r}", ResBlock(ch_in, ch_in, c.groups, dt))
            self.AttnBlock2D_0 = AttnBlock2D(ch_in, c.groups, dt)
            self.add_module(f"ResBlock_{r + 1}", ResBlock(ch_in, ch_in, c.groups, dt))
        self.GroupNorm_0 = GroupNorm(c.groups, ch_in, dt)
        self.add_module(f"Conv_{len(c.channel_mults)}",
                        Conv2d(ch_in, 2 * c.latent_channels, 3, dtype=dt))

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
    """``[B, Z, F/4, M/4] -> [B, 1, F, M]`` float32 log-mel."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        c, dt = cfg, cfg.dtype
        self.cfg = cfg
        mults = tuple(reversed(c.channel_mults))
        ch_in = c.base_channels * mults[0]
        self.Conv_0 = Conv2d(c.latent_channels, ch_in, 3, dtype=dt)
        r = 0
        if c.mid_attn:
            self.ResBlock_0 = ResBlock(ch_in, ch_in, c.groups, dt)
            self.AttnBlock2D_0 = AttnBlock2D(ch_in, c.groups, dt)
            self.ResBlock_1 = ResBlock(ch_in, ch_in, c.groups, dt)
            r = 2
        for i, mult in enumerate(mults):
            ch = c.base_channels * mult
            for _ in range(c.num_res_blocks):
                self.add_module(f"ResBlock_{r}", ResBlock(ch_in, ch, c.groups, dt))
                ch_in, r = ch, r + 1
            if i < len(mults) - 1:
                self.add_module(f"Conv_{i + 1}", Conv2d(ch, ch, 3, dtype=dt))
        self.GroupNorm_0 = GroupNorm(c.groups, ch_in, dt)
        self.add_module(f"Conv_{len(mults)}", Conv2d(ch_in, 1, 3, dtype=dt))

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
        return getattr(self, f"Conv_{len(c.channel_mults)}")(h).float()


class MelVAE(nn.Module):
    """Encode/decode log-mel images; deterministic (mean) inference path."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        if cfg.use_quant_conv:
            z = cfg.latent_channels
            self.quant_conv = Conv2d(2 * z, 2 * z, 1, dtype=cfg.dtype)
            self.post_quant_conv = Conv2d(z, z, 1, dtype=cfg.dtype)

    def moments(self, mel_img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[B, F, M, 1]`` -> ``(mean, logvar)`` each ``[B, F/4, M/4, Z]``."""
        h = self.encoder(mel_img.permute(0, 3, 1, 2))
        if self.cfg.use_quant_conv:
            h = self.quant_conv(h)
        mean, logvar = h.float().permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, mel_img: torch.Tensor) -> torch.Tensor:
        return self.moments(mel_img)[0] * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, F/4, M/4, Z] -> [B, F, M, 1]`` float32."""
        z = (z / self.cfg.scaling_factor).permute(0, 3, 1, 2)
        if self.cfg.use_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z).permute(0, 2, 3, 1)

    def forward(self, mel_img: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(mel_img))


def audioldm_vae_name_map(cfg: VAEConfig = VAEConfig()):
    """AudioLDM/Stable-Diffusion AutoencoderKL naming (``encoder.down.*``
    / ``decoder.up.*``, the layout FlashSR's ``vae.pth`` descends from)
    -> the flax tree paths of the JAX ``MelVAE`` (this module's names,
    ``/``-joined under ``params``; ``utils.weights.convert_state_dict``).

    Covers the full upstream structure: conv_in, per-level res blocks
    with nin_shortcut, down/upsample convs, the mid ResBlock/Attn/
    ResBlock pair (when ``cfg.mid_attn``), norm_out, conv_out, and the
    (post_)quant 1x1 convs (when ``cfg.use_quant_conv``).  Note the SD
    decoder indexing quirk: ``up.{u}`` lists levels in REVERSE
    application order, so u = L-1-i for our i-th applied level.
    """
    L = len(cfg.channel_mults)
    R = cfg.num_res_blocks
    m = {}

    def attn_block(prefix_t, path_f):
        m[f"{prefix_t}.norm.weight"] = f"{path_f}/GroupNorm_0/scale"
        m[f"{prefix_t}.norm.bias"] = f"{path_f}/GroupNorm_0/bias"
        for lin in ("q", "k", "v", "proj_out"):
            m[f"{prefix_t}.{lin}.weight"] = f"{path_f}/{lin}/kernel"
            m[f"{prefix_t}.{lin}.bias"] = f"{path_f}/{lin}/bias"

    def res_block(prefix_t, path_f, has_shortcut):
        m[f"{prefix_t}.norm1.weight"] = f"{path_f}/GroupNorm_0/scale"
        m[f"{prefix_t}.norm1.bias"] = f"{path_f}/GroupNorm_0/bias"
        m[f"{prefix_t}.conv1.weight"] = f"{path_f}/Conv_0/kernel"
        m[f"{prefix_t}.conv1.bias"] = f"{path_f}/Conv_0/bias"
        m[f"{prefix_t}.norm2.weight"] = f"{path_f}/GroupNorm_1/scale"
        m[f"{prefix_t}.norm2.bias"] = f"{path_f}/GroupNorm_1/bias"
        m[f"{prefix_t}.conv2.weight"] = f"{path_f}/Conv_1/kernel"
        m[f"{prefix_t}.conv2.bias"] = f"{path_f}/Conv_1/bias"
        if has_shortcut:
            m[f"{prefix_t}.nin_shortcut.weight"] = f"{path_f}/Conv_2/kernel"
            m[f"{prefix_t}.nin_shortcut.bias"] = f"{path_f}/Conv_2/bias"

    # encoder
    m["encoder.conv_in.weight"] = "params/encoder/Conv_0/kernel"
    m["encoder.conv_in.bias"] = "params/encoder/Conv_0/bias"
    for i in range(L):
        ch_in = cfg.channel_mults[i - 1] if i else 1
        for j in range(R):
            shortcut = (j == 0 and cfg.channel_mults[i] != ch_in)
            res_block(f"encoder.down.{i}.block.{j}",
                      f"params/encoder/ResBlock_{i * R + j}", shortcut)
        if i < L - 1:
            m[f"encoder.down.{i}.downsample.conv.weight"] = f"params/encoder/Conv_{i + 1}/kernel"
            m[f"encoder.down.{i}.downsample.conv.bias"] = f"params/encoder/Conv_{i + 1}/bias"
    if cfg.mid_attn:
        res_block("encoder.mid.block_1", f"params/encoder/ResBlock_{L * R}", False)
        attn_block("encoder.mid.attn_1", "params/encoder/AttnBlock2D_0")
        res_block("encoder.mid.block_2", f"params/encoder/ResBlock_{L * R + 1}", False)
    m["encoder.norm_out.weight"] = "params/encoder/GroupNorm_0/scale"
    m["encoder.norm_out.bias"] = "params/encoder/GroupNorm_0/bias"
    m["encoder.conv_out.weight"] = f"params/encoder/Conv_{L}/kernel"
    m["encoder.conv_out.bias"] = f"params/encoder/Conv_{L}/bias"

    # decoder (applied mults are reversed; upstream up.{u}: u = L-1-i)
    mults = tuple(reversed(cfg.channel_mults))
    m["decoder.conv_in.weight"] = "params/decoder/Conv_0/kernel"
    m["decoder.conv_in.bias"] = "params/decoder/Conv_0/bias"
    off = 0
    if cfg.mid_attn:
        res_block("decoder.mid.block_1", "params/decoder/ResBlock_0", False)
        attn_block("decoder.mid.attn_1", "params/decoder/AttnBlock2D_0")
        res_block("decoder.mid.block_2", "params/decoder/ResBlock_1", False)
        off = 2
    for i in range(L):
        u = L - 1 - i
        ch_in = mults[i - 1] if i else mults[0]
        for j in range(R):
            shortcut = (j == 0 and mults[i] != ch_in)
            res_block(f"decoder.up.{u}.block.{j}",
                      f"params/decoder/ResBlock_{off + i * R + j}", shortcut)
        if i < L - 1:
            m[f"decoder.up.{u}.upsample.conv.weight"] = f"params/decoder/Conv_{i + 1}/kernel"
            m[f"decoder.up.{u}.upsample.conv.bias"] = f"params/decoder/Conv_{i + 1}/bias"
    m["decoder.norm_out.weight"] = "params/decoder/GroupNorm_0/scale"
    m["decoder.norm_out.bias"] = "params/decoder/GroupNorm_0/bias"
    m["decoder.conv_out.weight"] = f"params/decoder/Conv_{L}/kernel"
    m["decoder.conv_out.bias"] = f"params/decoder/Conv_{L}/bias"
    if cfg.use_quant_conv:
        m["quant_conv.weight"] = "params/quant_conv/kernel"
        m["quant_conv.bias"] = "params/quant_conv/bias"
        m["post_quant_conv.weight"] = "params/post_quant_conv/kernel"
        m["post_quant_conv.bias"] = "params/post_quant_conv/bias"
    return m.get
