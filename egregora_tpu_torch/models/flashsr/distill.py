"""The shipped compact FlashSR trios, and the resolver of the node's weights.

Counterpart of the loading half of ``egregora_tpu/models/flashsr/
distill.py`` (``_cfg_from_json``, ``_LEGACY_DISTILLED``,
``load_pretrained_with_cfg``, ``resolve_flashsr``).  The JAX package
ships two distilled trios as data files, ``pretrained_istft.npz`` (the
served default: phase-conditioned exciter ``SpectralVocoder``) and
``pretrained.npz`` (the HiFi-GAN ``SRVocoder``).  The port reads them in
place, by path, from the checkout: flat ``/``-joined flax keys, float16
values cast to float32, and a ``__config__`` JSON entry with the
geometry.  ``utils.weights.params_from_jax`` maps them onto the port's
modules, key for key.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...utils.weights import params_from_jax, unflatten
from .ldm_unet import LDMUNetConfig
from .pipeline import FlashSRConfig
from .unet import UNetConfig
from .vae import VAEConfig
from .vocoder import VocoderConfig

SHIPPED_DIR = Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "flashsr"
PRETRAINED = SHIPPED_DIR / "pretrained.npz"
PRETRAINED_ISTFT = SHIPPED_DIR / "pretrained_istft.npz"
CONVERTED_FILES = ("student_ldm.pth", "sr_vocoder.pth", "vae.pth")

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def _cfg_from_json(s: str) -> FlashSRConfig:
    """The ``__config__`` entry of a shipped npz -> the port's config."""
    d = json.loads(s)

    def dec(cls, dd):
        return cls(**{k: _deep_tuple(v) for k, v in dd.items()})

    unet_cls = LDMUNetConfig if d.get("unet_kind") == "ldm" else UNetConfig
    return FlashSRConfig(vae=dec(VAEConfig, d["vae"]),
                         unet=dec(unet_cls, d["unet"]),
                         vocoder=dec(VocoderConfig, d["vocoder"]),
                         crossover_hz=d["crossover_hz"],
                         noise_seed=d["noise_seed"],
                         envelope_match=d.get("envelope_match", False),
                         adaptive_crossover=d.get("adaptive_crossover", True))


# geometry of shipped npz files that predate the embedded config
_LEGACY_DISTILLED = FlashSRConfig(
    vae=VAEConfig(base_channels=24, channel_mults=(1, 2, 4), latent_channels=16,
                  num_res_blocks=1, groups=8, mid_attn=False, use_quant_conv=False),
    unet=UNetConfig(in_channels=32, out_channels=16, base_channels=48,
                    channel_mults=(1, 2), num_res_blocks=1, attn_levels=(),
                    num_heads=4, time_dim=128, groups=8),
    vocoder=VocoderConfig(upsample_initial=128, channel_floor=16),
)


def load_pretrained_with_cfg(path: Path = PRETRAINED
                             ) -> Optional[Tuple[FlashSRConfig, StateDicts]]:
    """``(config, state dicts)`` of a shipped trio, or None if the file is
    absent."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        files = list(z.files)
        if "__config__" in files:
            cfg = _cfg_from_json(bytes(z["__config__"].tobytes()).decode())
            files.remove("__config__")
        else:
            cfg = _LEGACY_DISTILLED
        tree = unflatten({k: z[k].astype(np.float32) for k in files})
    return cfg, params_from_jax(cfg, tree)


def weights_dir() -> Path:
    """The converted-checkpoint root the JAX package reads:
    ``EGREGORA_TPU_WEIGHTS``, else ``~/.cache/egregora_tpu/weights``;
    FlashSR's files sit in its ``flashsr`` folder."""
    env = os.environ.get("EGREGORA_TPU_WEIGHTS")
    root = Path(env) if env else Path.home() / ".cache" / "egregora_tpu" / "weights"
    return root / "flashsr"


def resolve_flashsr(seed: int = 0) -> Tuple[FlashSRConfig, Optional[StateDicts], str]:
    """``(config, state dicts, source)`` for the node, in the JAX
    resolver's order:

    1. converted reference checkpoints (the cache ``flashsr_params.npz``
       or all three ``.pth`` files in ``weights_dir()``): not ported yet,
       raises ``NotImplementedError``; nothing is ever fetched;
    2. the shipped istft trio ``pretrained_istft.npz`` ("distilled-istft"),
       unless ``EGREGORA_FLASHSR_VARIANT=hifigan``;
    3. the shipped HiFi-GAN trio ``pretrained.npz`` ("distilled");
    4. the full config with no weights ("random": the pipeline draws
       them from ``seed``)."""
    d = weights_dir()
    if (d / "flashsr_params.npz").exists() or all((d / f).exists() for f in CONVERTED_FILES):
        raise NotImplementedError(
            f"converted FlashSR checkpoints in {d}: loading them is not ported "
            "yet (a later slice; ROADMAP.md, Queue 1)")
    variant = os.environ.get("EGREGORA_FLASHSR_VARIANT", "").strip().lower()
    if variant != "hifigan":
        shipped = load_pretrained_with_cfg(PRETRAINED_ISTFT)
        if shipped is not None:
            return shipped[0], shipped[1], "distilled-istft"
        if variant in ("istft", "vocos"):
            print(f"[egregora_tpu_torch] FlashSR: EGREGORA_FLASHSR_VARIANT={variant!r} "
                  f"but no {PRETRAINED_ISTFT.name} shipped; falling back to the "
                  "HiFi-GAN trio")
    shipped = load_pretrained_with_cfg(PRETRAINED)
    if shipped is not None:
        return shipped[0], shipped[1], "distilled"
    print("[egregora_tpu_torch] FlashSR: no checkpoints and no shipped distilled "
          "weights; using seeded random init (output will not be enhanced)")
    return FlashSRConfig(), None, "random"
