"""Infer the FlashSR sub-models' geometry from checkpoint tensor shapes.

Counterpart of ``egregora_tpu/models/flashsr/geometry.py``, returning the
port's config classes.  The three reference checkpoints (``vae.pth``,
``student_ldm.pth``, ``sr_vocoder.pth``) carry no config, but their
state dicts encode almost all of it: channel counts, level counts, block
counts, kernel sizes and attention placement are read from tensor shapes
and key structure.  ``infer_flashsr_config`` derives a full
``FlashSRConfig`` from them, so a trio at any width and depth loads as
it is.  Fields a shape cannot encode are documented per function and
kept at the upstream lineage's defaults (``EGREGORA_FLASHSR_NUM_HEADS``
overrides the UNet's head count).

Every inference failure raises ``GeometryError`` with the offending keys
and shapes; nothing half-loads.
"""
from __future__ import annotations

import math
import os
import re
from typing import Dict

import numpy as np

from .ldm_unet import LDMUNetConfig
from .pipeline import FlashSRConfig
from .vae import VAEConfig
from .vocoder import VocoderConfig


class GeometryError(ValueError):
    """Checkpoint structure doesn't match the expected upstream layout."""


def _shape_report(sd: Dict[str, np.ndarray], pattern: str = "",
                  limit: int = 12) -> str:
    keys = [k for k in sorted(sd) if pattern in k][:limit]
    lines = [f"  {k}: {tuple(np.asarray(sd[k]).shape)}" for k in keys]
    return "\n".join(lines) if lines else "  (no matching keys)"


def _need(sd: Dict[str, np.ndarray], key: str, what: str) -> np.ndarray:
    if key not in sd:
        raise GeometryError(
            f"cannot infer {what}: expected key {key!r} not in checkpoint.\n"
            f"Nearby keys:\n{_shape_report(sd, key.split('.')[0])}")
    return np.asarray(sd[key])


def _indices(sd: Dict[str, np.ndarray], pattern: str) -> list[int]:
    """Sorted distinct integers captured by ``pattern``'s first group."""
    rx = re.compile(pattern)
    found = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    return sorted(found)


# VAE (AudioLDM / Stable-Diffusion AutoencoderKL layout)

def infer_vae_config(sd: Dict[str, np.ndarray], groups: int = 0):
    """``VAEConfig`` from an AutoencoderKL state dict.

    Shape-derivable: base_channels, channel_mults, num_res_blocks,
    latent_channels, mid_attn, use_quant_conv.  NOT derivable: ``groups``
    (GroupNorm stores per-channel affine only; upstream uses 32 — the
    default here is gcd(32, every level width) so non-32-divisible
    checkpoints still construct) and ``scaling_factor`` (a float held in
    the model config, not the state dict; AudioLDM lineage value kept).
    """
    base = int(_need(sd, "encoder.conv_in.weight", "vae base_channels").shape[0])
    levels = _indices(sd, r"encoder\.down\.(\d+)\.block\.0\.conv1\.weight")
    if levels != list(range(len(levels))) or not levels:
        raise GeometryError(
            f"vae encoder levels not contiguous from 0: {levels}.\n"
            f"{_shape_report(sd, 'encoder.down')}")
    blocks = _indices(sd, r"encoder\.down\.0\.block\.(\d+)\.conv1\.weight")
    R = len(blocks)
    mults = []
    for i in levels:
        w = _need(sd, f"encoder.down.{i}.block.{R - 1}.conv2.weight",
                  f"vae level-{i} width")
        ch = int(w.shape[0])
        if ch % base:
            raise GeometryError(
                f"vae level {i} channels {ch} not a multiple of base {base}")
        mults.append(ch // base)
    latent2 = int(_need(sd, "encoder.conv_out.weight",
                        "vae latent_channels").shape[0])
    if latent2 % 2:
        raise GeometryError(
            f"vae encoder.conv_out out-channels {latent2} is odd — expected "
            "2*latent (mean ++ logvar moments)")
    groups = groups or math.gcd(32, *(base * m for m in mults))
    return VAEConfig(base_channels=base, channel_mults=tuple(mults),
                     latent_channels=latent2 // 2, num_res_blocks=R,
                     groups=groups,
                     mid_attn="encoder.mid.attn_1.q.weight" in sd,
                     use_quant_conv="quant_conv.weight" in sd)


# Student LDM UNet (CompVis UNetModel layout)

def infer_ldm_unet_config(sd: Dict[str, np.ndarray], groups: int = 0):
    """``LDMUNetConfig`` from a CompVis UNetModel state dict.

    Shape-derivable: in/out/model channels, channel_mult, num_res_blocks,
    attention_resolutions (ds values at which ``input_blocks.{i}.1.qkv``
    exists).  NOT derivable: ``num_heads`` — the fused qkv tensor is
    ``[3C, C, 1]`` for any head count.  Default 8 (CompVis/AudioSR
    lineage); override with ``EGREGORA_FLASHSR_NUM_HEADS`` — getting it
    wrong mis-permutes the legacy head-major qkv layout, so the value is
    also recorded in the conversion log.
    """
    w_in = _need(sd, "input_blocks.0.0.weight", "unet model_channels")
    mc, in_ch = int(w_in.shape[0]), int(w_in.shape[1])
    out_ch = int(_need(sd, "out.2.weight", "unet out_channels").shape[0])

    idxs = _indices(sd, r"input_blocks\.(\d+)\.")
    if idxs != list(range(len(idxs))):
        raise GeometryError(f"input_blocks indices not contiguous: {idxs}")

    # walk the encoder side: split into levels at Downsample ops
    level_res_out: list[list[int]] = [[]]   # out-channels per resblock
    level_attn: list[bool] = [False]
    for idx in idxs[1:]:
        if f"input_blocks.{idx}.0.op.weight" in sd:           # Downsample
            level_res_out.append([])
            level_attn.append(False)
            continue
        w = _need(sd, f"input_blocks.{idx}.0.in_layers.2.weight",
                  f"unet input block {idx}")
        level_res_out[-1].append(int(w.shape[0]))
        if f"input_blocks.{idx}.1.qkv.weight" in sd:
            level_attn[-1] = True

    R_set = {len(v) for v in level_res_out}
    if len(R_set) != 1:
        raise GeometryError(
            f"unet levels have differing res-block counts {level_res_out} — "
            "not a uniform UNetModel")
    R = R_set.pop()
    mults = []
    for li, outs in enumerate(level_res_out):
        ch = outs[-1]
        if ch % mc:
            raise GeometryError(
                f"unet level {li} channels {ch} not a multiple of "
                f"model_channels {mc}")
        mults.append(ch // mc)
    attn_res = tuple(2 ** li for li, a in enumerate(level_attn) if a)

    heads = int(os.environ.get("EGREGORA_FLASHSR_NUM_HEADS", "8"))
    # heads must divide the channel count at every attention site
    # (each attn level + the middle block, which always has attention)
    attn_ch = [mc * m for li, m in enumerate(mults) if level_attn[li]]
    attn_ch.append(mc * mults[-1])
    while heads > 1 and any(c % heads for c in attn_ch):
        heads //= 2
    groups = groups or math.gcd(32, *(mc * m for m in mults))
    return LDMUNetConfig(in_channels=in_ch, out_channels=out_ch,
                         model_channels=mc, channel_mult=tuple(mults),
                         num_res_blocks=R, attention_resolutions=attn_res,
                         num_heads=heads, groups=groups)


# SR vocoder (HiFi-GAN generator, jik876 layout)

def infer_vocoder_config(sd: Dict[str, np.ndarray]):
    """``VocoderConfig`` from a HiFi-GAN generator state dict
    (weight-norm pairs folded first).

    Shape-derivable: n_mels, upsample_initial, upsample kernel sizes and
    per-stage channels (-> channel_floor), resblock kernel sizes and
    per-branch conv counts.  NOT derivable: upsample FACTORS (stride is
    not a tensor shape) — inferred as kernel//2, the k = 2f convention
    every HiFi-GAN lineage config uses (10/20, 8/16, 6/12 here) — and
    dilation VALUES (dilation doesn't change a conv weight's shape);
    the (1, 3, 5) HiFi-GAN v1 schedule is assumed.
    """
    from ...utils.weights import fold_weight_norm

    sd = fold_weight_norm(dict(sd))
    w_pre = _need(sd, "conv_pre.weight", "vocoder upsample_initial")
    init, n_mels = int(w_pre.shape[0]), int(w_pre.shape[1])

    ups = _indices(sd, r"ups\.(\d+)\.weight")
    if ups != list(range(len(ups))) or not ups:
        raise GeometryError(
            f"vocoder ups.* not contiguous from 0: {ups}\n"
            f"{_shape_report(sd, 'ups.')}")
    kernels, chans = [], []
    for i in ups:
        w = np.asarray(sd[f"ups.{i}.weight"])   # ConvTranspose1d [in, out, k]
        kernels.append(int(w.shape[2]))
        chans.append(int(w.shape[1]))
    factors = tuple(k // 2 for k in kernels)

    # channel_floor must reproduce the observed widths via max(ch//2, floor)
    floor = min(chans)
    ch = init
    for i, actual in enumerate(chans):
        ch = max(ch // 2, floor)
        if ch != actual:
            raise GeometryError(
                f"vocoder stage {i} has {actual} channels; the halving-with-"
                f"floor rule (floor {floor}) predicts {ch}.\n"
                f"{_shape_report(sd, 'ups.')}")

    rb = _indices(sd, r"resblocks\.(\d+)\.convs1\.0\.weight")
    n_stages = len(ups)
    if not rb or len(rb) % n_stages:
        raise GeometryError(
            f"vocoder has {len(rb)} resblocks over {n_stages} stages — not "
            f"a uniform MRF grid\n{_shape_report(sd, 'resblocks.')}")
    nk = len(rb) // n_stages
    res_kernels = tuple(
        int(np.asarray(sd[f"resblocks.{j}.convs1.0.weight"]).shape[2])
        for j in range(nk))
    n_dil = len(_indices(sd, r"resblocks\.0\.convs1\.(\d+)\.weight"))
    dil = (1, 3, 5)[:n_dil] if n_dil <= 3 else tuple(
        1 + 2 * i for i in range(n_dil))
    return VocoderConfig(n_mels=n_mels, upsample_initial=init,
                         upsample_factors=factors,
                         upsample_kernels=tuple(kernels),
                         resblock_kernels=res_kernels,
                         resblock_dilations=(dil,) * nk,
                         channel_floor=floor)


def infer_flashsr_config(sd_vae: Dict[str, np.ndarray],
                         sd_unet: Dict[str, np.ndarray],
                         sd_voc: Dict[str, np.ndarray]):
    """Full ``FlashSRConfig`` from the three reference checkpoints'
    state dicts (``vae.pth``, ``student_ldm.pth``, ``sr_vocoder.pth``)."""
    return FlashSRConfig(vae=infer_vae_config(sd_vae),
                         unet=infer_ldm_unet_config(sd_unet),
                         vocoder=infer_vocoder_config(sd_voc))
