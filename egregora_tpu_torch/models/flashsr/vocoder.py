"""The FlashSR vocoders: mel -> 48 kHz wave.

Counterpart of ``egregora_tpu/models/flashsr/vocoder.py``:

* ``SRVocoder`` (FlashSR's ``sr_vocoder.pth`` layout, ``kind="hifigan"``):
  a HiFi-GAN generator with transposed-conv upsampling through the 480x
  hop (10*8*6) and multi-receptive-field (``MRF``) residual stacks
  between stages.  ``forward`` is the module path; ``apply_fused`` runs
  each stage's MRF through the hand-written kernels of ``csrc/mrf.cu``
  (``ops.mrf_fused``, ``ops.mrf_rows``) with the same weights.  ``forward``
  takes NWC mel ``[B, F, n_mels]``; inside, tensors are NCW.
* ``SpectralVocoder`` (``kind="istft"``): a ConvNeXt backbone at frame
  rate predicting log-magnitude and phase of a 1920-point STFT, inverted
  by ``ops.stft.istft_dense``; with ``phase_cond`` it sees the input
  chunk's STFT (and, with ``exciter``, that of its square and cube)
  through gated phase candidates.  Tensors are NWC ``[B, F, D]``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.mrf_fused import mrf_fused_cm, pack_resblock_weights
from ...ops.mrf_rows import mrf_rows
from ...ops.stft import istft_dense, stft_conv
from .layers import Conv1d, ConvTranspose1d, Dense, LayerNorm, leaky_relu
from .mel import _reflect_pad


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
    # "hifigan" -> SRVocoder, "istft" -> SpectralVocoder
    kind: str = "hifigan"
    hidden: int = 256            # istft backbone width
    depth: int = 6               # istft ConvNeXt-1D blocks
    mlp_ratio: int = 3
    istft_nfft: int = 1920       # 4 * hop(480)
    phase_cond: bool = False     # condition on the input chunk's STFT
    exciter: bool = False        # + the STFTs of its square and cube


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


ROWS_TILES = (4096, 2048, 1024, 512, 256, 128)


def apply_fused(voc: SRVocoder, mel: torch.Tensor) -> torch.Tensor:
    """``SRVocoder.forward`` with each MRF on the hand-written kernels,
    the stage dispatch of the JAX ``apply_fused``:

    * ``EGREGORA_MRF_PATH=rows``: the NWC kernel (``ops.mrf_rows``, one
      launch a branch) on every stage whose T a tile of ``ROWS_TILES``
      divides, the module path on the others;
    * otherwise (unset or ``pallas``): the channel-major kernel
      (``ops.mrf_fused``, one launch a stage) on stages of C <= 64, the
      module path on wider ones;
    * ``dense`` and ``packed``, the JAX package's XLA layout engines, are
      not ported.

    Pre/post convs and the transposed convs are the modules themselves."""
    c = voc.cfg
    if any(tuple(d) != tuple(c.resblock_dilations[0]) for d in c.resblock_dilations):
        raise NotImplementedError(
            "apply_fused: per-branch resblock_dilations differ "
            f"({c.resblock_dilations}); the fused MRF kernels apply one schedule "
            "to every branch; use SRVocoder.forward for this config")
    path = os.environ.get("EGREGORA_MRF_PATH", "pallas")
    if path in ("dense", "packed"):
        raise NotImplementedError(
            f"EGREGORA_MRF_PATH={path}: the JAX package's {path} MRF engine is not "
            "ported (ROADMAP.md, Queue 1); use pallas or rows")
    dils = c.resblock_dilations[0]
    h = voc.Conv_0(mel.transpose(1, 2))
    for i in range(len(c.upsample_factors)):
        h = getattr(voc, f"ConvTranspose_{i}")(leaky_relu(h))
        mrf = getattr(voc, f"MRF_{i}")
        ch, t = h.shape[1], h.shape[2]
        if path == "rows":
            if any(t % tile == 0 for tile in ROWS_TILES):
                w, b = pack_resblock_weights(mrf, c.dtype)
                h = mrf_rows(h.to(c.dtype).transpose(1, 2).contiguous(), w, b,
                             c.resblock_kernels, dils).transpose(1, 2)
            else:
                h = mrf(h)
        elif ch <= 64:
            w, b = pack_resblock_weights(mrf, c.dtype)
            h = mrf_fused_cm(h.to(c.dtype).contiguous(), w, b, c.resblock_kernels, dils)
        else:
            h = mrf(h)
    h = voc.Conv_1(leaky_relu(h))
    return torch.tanh(h.float())[:, 0]


class ConvNeXtBlock1D(nn.Module):
    """Frame-rate ConvNeXt block on ``[B, F, D]``: depthwise k=7 mixing
    along frames as seven shifted multiply-adds in the compute dtype,
    LayerNorm, pointwise MLP with tanh-approximate GELU (flax
    ``nn.gelu``), residual."""

    def __init__(self, dim: int, mlp: int, dtype: torch.dtype):
        super().__init__()
        self.dw_kernel = nn.Parameter(torch.zeros(7, dim))
        self.dw_bias = nn.Parameter(torch.zeros(dim))
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.Dense_0 = Dense(dim, mlp, dtype)
        self.Dense_1 = Dense(mlp, dim, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = x.shape[1]
        xp = F.pad(x.to(self.dtype), (0, 0, 3, 3))
        w = self.dw_kernel.to(self.dtype)
        h = self.dw_bias.to(self.dtype)
        for j in range(7):
            h = h + xp[:, j: j + f, :] * w[j]
        h = self.Dense_0(self.LayerNorm_0(h))
        h = self.Dense_1(F.gelu(h, approximate="tanh"))
        return x + h


def _phasor(re: torch.Tensor, im: torch.Tensor):
    """Unit phasor and magnitude of an STFT: ``(re/(m+1e-6), im/(m+1e-6), m)``."""
    m = torch.sqrt(re * re + im * im)
    inv = 1.0 / (m + 1e-6)
    return re * inv, im * inv, m


class SpectralVocoder(nn.Module):
    """Complex-spectrum vocoder head: ``mel [B, F, n_mels] -> [B, F*480]``
    (``ref [B, F*480]``, the input chunk, when ``phase_cond``)."""

    def __init__(self, cfg: VocoderConfig = VocoderConfig(kind="istft")):
        super().__init__()
        self.cfg = c = cfg
        dt = c.dtype
        nbins = c.istft_nfft // 2 + 1
        self.Conv_0 = Conv1d(c.n_mels, c.hidden, 7, dtype=dt)
        self.LayerNorm_0 = LayerNorm(c.hidden, dt)
        if c.phase_cond:
            n_feats = (13 if c.exciter else 7) * nbins
            self.phase_in = Dense(n_feats, c.hidden, dt)
        for i in range(c.depth):
            self.add_module(f"ConvNeXtBlock1D_{i}",
                            ConvNeXtBlock1D(c.hidden, c.hidden * c.mlp_ratio, dt))
        self.LayerNorm_1 = LayerNorm(c.hidden, dt)
        self.Dense_0 = Dense(c.hidden, nbins, dt)
        self.Dense_1 = Dense(c.hidden, 2 * nbins, dt)
        if c.phase_cond:
            self.phase_gates = Dense(c.hidden, (10 if c.exciter else 6) * nbins, dt)
            self.mag_gate = Dense(c.hidden, nbins, dt)

    def _features(self, ref: torch.Tensor, f: int):
        """The input chunk's phase features on the head's synthesis grid
        (frame f centred at f*hop), each cut or zero-padded to ``f``
        frames: unit phasor, log-magnitude, the 2nd/3rd-harmonic phase
        candidates and, with ``exciter``, the phasors and log-magnitudes
        of the STFTs of the chunk's square and cube."""
        n_fft, hop = self.cfg.istft_nfft, 480
        nbins = n_fft // 2 + 1

        def stft(sig):
            return stft_conv(_reflect_pad(sig, n_fft // 2), n_fft, hop)

        def cut(a):
            a = a[:, :f]
            return F.pad(a, (0, 0, 0, f - a.shape[1]))

        cos, sin, m = _phasor(*stft(ref.float()))
        idx2 = torch.arange(nbins, device=ref.device) // 2
        idx3 = torch.arange(nbins, device=ref.device) // 3
        c2 = cos * cos - sin * sin
        s2 = 2.0 * cos * sin
        c3 = c2 * cos - s2 * sin
        s3 = s2 * cos + c2 * sin
        feats = [cos, sin, torch.log(m + 1e-5), c2[..., idx2], s2[..., idx2],
                 c3[..., idx3], s3[..., idx3]]
        if self.cfg.exciter:
            xn = ref.float()
            xn = xn * torch.rsqrt(torch.mean(xn * xn, dim=-1, keepdim=True) + 1e-12)
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
        x = self.Conv_0(mel.to(c.dtype).transpose(1, 2)).transpose(1, 2)
        x = self.LayerNorm_0(x)
        if c.phase_cond:
            if ref is None:
                raise ValueError("phase_cond vocoder needs the input chunk")
            feats = self._features(ref, f)
            x = x + self.phase_in(torch.cat(feats, dim=-1).to(c.dtype))
        for i in range(c.depth):
            x = getattr(self, f"ConvNeXtBlock1D_{i}")(x)
        x = self.LayerNorm_1(x)
        logmag = self.Dense_0(x).float()
        ph = self.Dense_1(x).float()
        pr, pi = ph[..., :nbins], ph[..., nbins:]
        if c.phase_cond:
            cos, sin, logm_in, c2h, s2h, c3h, s3h = feats[:7]
            gs = self.phase_gates(x).float().split(nbins, dim=-1)
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
            gm = torch.sigmoid(self.mag_gate(x).float())
            logmag = logmag + gm * logm_in
        inv = torch.rsqrt(pr * pr + pi * pi + 1e-6)
        mag = torch.exp(torch.clamp(logmag, -30.0, 9.0))
        y = istft_dense(mag * pr * inv, mag * pi * inv, n_fft, hop)
        return y[..., n_fft // 2: n_fft // 2 + f * hop]


def build_vocoder(cfg: VocoderConfig) -> nn.Module:
    """``SpectralVocoder`` for ``kind="istft"``, else ``SRVocoder``."""
    return SpectralVocoder(cfg) if cfg.kind == "istft" else SRVocoder(cfg)

