"""SR vocoder (FlashSR's ``sr_vocoder.pth`` layout): mel -> 48 kHz wave.

Counterpart of the module path of ``egregora_tpu/models/flashsr/
vocoder.py`` (``SRVocoder``, ``MRF``, ``ResBlock1D``): a HiFi-GAN
generator with transposed-conv upsampling through the 480x hop
(10*8*6) and multi-receptive-field residual stacks between stages.  The
JAX package runs the same modules by default; its fused Pallas MRF
kernels (``EGREGORA_FUSED_VOCODER=1``) are not ported yet.  ``forward``
takes NWC mel ``[B, F, n_mels]``; inside, tensors are NCW.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn

from .layers import Conv1d, ConvTranspose1d, leaky_relu


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    n_mels: int = 256
    upsample_initial: int = 512
    upsample_factors: Sequence[int] = (10, 8, 6)   # product == hop 480
    upsample_kernels: Sequence[int] = (20, 16, 12)
    resblock_kernels: Sequence[int] = (3, 7, 11)
    resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    channel_floor: int = 64
    dtype: torch.dtype = torch.bfloat16
    # "hifigan" is the only kind ported so far ("istft" is the next slice)
    kind: str = "hifigan"


class ResBlock1D(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            self.add_module(f"Conv_{2 * i}", Conv1d(channels, channels, kernel, d, dtype))
            self.add_module(f"Conv_{2 * i + 1}", Conv1d(channels, channels, kernel, 1, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dilations)):
            h = getattr(self, f"Conv_{2 * i}")(leaky_relu(x))
            h = getattr(self, f"Conv_{2 * i + 1}")(leaky_relu(h))
            x = x + h
        return x


class MRF(nn.Module):
    def __init__(self, channels: int, kernels: Sequence[int],
                 dilations: Sequence[Sequence[int]], dtype: torch.dtype):
        super().__init__()
        self.n = len(kernels)
        for j, (k, ds) in enumerate(zip(kernels, dilations)):
            self.add_module(f"ResBlock1D_{j}", ResBlock1D(channels, k, ds, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for j in range(self.n):
            h = getattr(self, f"ResBlock1D_{j}")(x)
            acc = h if acc is None else acc + h
        return acc / self.n


class SRVocoder(nn.Module):
    """``mel [B, F, n_mels] -> waveform [B, F * prod(upsample_factors)]``."""

    def __init__(self, cfg: VocoderConfig = VocoderConfig()):
        super().__init__()
        if cfg.kind != "hifigan":
            raise NotImplementedError(f"vocoder kind {cfg.kind!r} is not ported yet")
        self.cfg = c = cfg
        self.Conv_0 = Conv1d(c.n_mels, c.upsample_initial, 7, dtype=c.dtype)
        ch = c.upsample_initial
        for i, (f, k) in enumerate(zip(c.upsample_factors, c.upsample_kernels)):
            out = max(ch // 2, c.channel_floor)
            self.add_module(f"ConvTranspose_{i}", ConvTranspose1d(ch, out, k, f, c.dtype))
            self.add_module(f"MRF_{i}", MRF(out, c.resblock_kernels,
                                            c.resblock_dilations, c.dtype))
            ch = out
        self.Conv_1 = Conv1d(ch, 1, 7, dtype=c.dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(mel.transpose(1, 2))
        for i in range(len(self.cfg.upsample_factors)):
            h = getattr(self, f"ConvTranspose_{i}")(leaky_relu(h))
            h = getattr(self, f"MRF_{i}")(h)
        h = self.Conv_1(leaky_relu(h))
        return torch.tanh(h.float())[:, 0]

