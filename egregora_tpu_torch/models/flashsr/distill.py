"""FlashSR weights for the node: converted reference checkpoints, the
shipped compact trios, and the resolver that picks one.

Counterpart of the loading half of ``egregora_tpu/models/flashsr/
distill.py`` (``_cfg_to_json``, ``_cfg_from_json``, ``_LEGACY_DISTILLED``,
``load_pretrained_with_cfg``, ``resolve_flashsr``) and of the JAX
package's ``utils/weights.load_converted_flashsr``.

Reference checkpoints: the three ``.pth`` files of upstream FlashSR
(``vae.pth``, ``student_ldm.pth``, ``sr_vocoder.pth``) in
``weights_dir()``.  Their geometry is inferred from the tensor shapes
(``geometry.infer_flashsr_config``), each file is mapped by its upstream
name map onto the JAX package's flax tree and then onto the port, and
the converted arrays are cached beside them as ``flashsr_params.npz``
with a ``flashsr_params.cfg.json`` sidecar, in the JAX package's format:
a cache either package wrote loads in the other.  With files missing the
resolver makes one first-use download attempt (``utils.fetch``; off under
``EGREGORA_TPU_OFFLINE``), then falls through to the shipped trios.

Shipped trios: the JAX package ships two distilled trios as data files, ``pretrained_istft.npz`` (the
served default: phase-conditioned exciter ``SpectralVocoder``) and
``pretrained.npz`` (the HiFi-GAN ``SRVocoder``).  The port reads them in
place, by path, from the checkout: flat ``/``-joined flax keys, float16
values cast to float32, and a ``__config__`` JSON entry with the
geometry.  ``utils.weights.params_from_jax`` maps them onto the port's
modules, key for key.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ...utils.fetch import (FLASHSR_FILES as CONVERTED_FILES, FETCHED, auto_fetch_flashsr,
                            fetched_files, missing_flashsr_files)
from ...utils.weights import (convert_state_dict, flax_tree, load_params,
                              load_torch_state_dict, params_from_jax, save_params,
                              unflatten)
from .geometry import infer_flashsr_config
from .ldm_unet import LDMUNetConfig, ldm_unet_name_map
from .pipeline import FlashSRConfig, FlashSRModules
from .unet import UNetConfig
from .vae import VAEConfig, audioldm_vae_name_map
from .vocoder import VocoderConfig, hifigan_name_map

SHIPPED_DIR = Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "flashsr"
PRETRAINED = SHIPPED_DIR / "pretrained.npz"
PRETRAINED_ISTFT = SHIPPED_DIR / "pretrained_istft.npz"
CACHE = "flashsr_params.npz"
SIDECAR = "flashsr_params.cfg.json"

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def _cfg_to_json(cfg: FlashSRConfig) -> str:
    """The geometry of a trio as the JAX package writes it: each
    sub-config's fields but ``dtype`` (code policy, not checkpoint state),
    the UNet tagged by kind."""
    def enc(o):
        return {f.name: getattr(o, f.name) for f in dataclasses.fields(o) if f.name != "dtype"}

    return json.dumps({"vae": enc(cfg.vae), "unet": enc(cfg.unet),
                       "unet_kind": ("ldm" if isinstance(cfg.unet, LDMUNetConfig)
                                     else "student"),
                       "vocoder": enc(cfg.vocoder),
                       "crossover_hz": cfg.crossover_hz,
                       "noise_seed": cfg.noise_seed,
                       "envelope_match": cfg.envelope_match,
                       "adaptive_crossover": cfg.adaptive_crossover})


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


def convert_flashsr_trio(cfg: FlashSRConfig, sds: Dict[str, Dict[str, np.ndarray]],
                         d: Path) -> Dict[str, dict]:
    """The three checkpoints' state dicts (keyed like the trio) mapped by
    their upstream name maps onto the JAX package's flax trees for
    ``cfg`` (numpy leaves), cached in ``d`` as ``CACHE`` with the
    ``SIDECAR`` geometry."""
    with torch.device("meta"):
        mods = FlashSRModules(cfg)
    maps = {"vae": audioldm_vae_name_map(cfg.vae),
            "sr_vocoder": hifigan_name_map(cfg.vocoder),
            "student_ldm": ldm_unet_name_map(cfg.unet)}
    converted = {name: convert_state_dict(sds[name], flax_tree(m), name_map=maps[name])
                 for name, m in mods.by_name().items()}
    save_params(converted, d / CACHE)
    (d / SIDECAR).write_text(_cfg_to_json(cfg))
    return converted


def load_converted_flashsr(ckpt_dir: Optional[Path] = None
                           ) -> Optional[Tuple[FlashSRConfig, StateDicts]]:
    """``(config, state dicts)`` of the reference checkpoints in
    ``ckpt_dir`` (default ``weights_dir()``), or None when they are not
    all there.  The cache comes first (its sidecar's geometry, or the full
    config for a cache without one); else the three ``.pth`` files, with
    the geometry inferred from their shapes, converted and cached.  With
    files missing it makes the JAX resolver's first-use download attempt
    (``utils.fetch.auto_fetch_flashsr``: once per directory per process,
    none under ``EGREGORA_TPU_OFFLINE``) before giving up.  A file that
    fetch downloaded is read as tensors only (``weights_only``), and one
    that holds anything else raises; files put in place by hand are
    unpickled whole, as the JAX package does."""
    d = Path(ckpt_dir) if ckpt_dir is not None else weights_dir()
    cache, sidecar = d / CACHE, d / SIDECAR
    if cache.exists():
        cfg = _cfg_from_json(sidecar.read_text()) if sidecar.exists() else FlashSRConfig()
        return cfg, params_from_jax(cfg, load_params(cache))
    missing = missing_flashsr_files(d)
    if missing and not auto_fetch_flashsr(d):
        if len(missing) < len(CONVERTED_FILES):
            print(f"[egregora_tpu_torch] FlashSR: {d} lacks {', '.join(missing)}; "
                  "the reference checkpoints are skipped")
        return None
    fetched = fetched_files(d)
    sds = {}
    for name in ("vae", "student_ldm", "sr_vocoder"):
        f = f"{name}.pth"
        try:
            sds[name] = load_torch_state_dict(d / f, weights_only=f in fetched)
        except Exception as e:
            if f not in fetched:
                raise
            raise RuntimeError(
                f"{d / f} was downloaded and holds more than tensors, so it is not "
                f"loaded; delete it, or put a trusted copy there by hand and take its "
                f"name out of {d / FETCHED}") from e
    cfg = infer_flashsr_config(sds["vae"], sds["student_ldm"], sds["sr_vocoder"])
    print(f"[egregora_tpu_torch] FlashSR geometry inferred from checkpoints: "
          f"vae base={cfg.vae.base_channels} mults={cfg.vae.channel_mults}; "
          f"unet mc={cfg.unet.model_channels} mult={cfg.unet.channel_mult} "
          f"heads={cfg.unet.num_heads} (not shape-recoverable; "
          f"EGREGORA_FLASHSR_NUM_HEADS overrides); vocoder "
          f"init={cfg.vocoder.upsample_initial} factors={cfg.vocoder.upsample_factors}")
    return cfg, params_from_jax(cfg, convert_flashsr_trio(cfg, sds, d))


def resolve_flashsr(seed: int = 0) -> Tuple[FlashSRConfig, Optional[StateDicts], str]:
    """``(config, state dicts, source)`` for the node, in the JAX
    resolver's order:

    1. converted reference checkpoints (the cache ``flashsr_params.npz``
       or all three ``.pth`` files in ``weights_dir()``, after one
       first-use download attempt; "converted");
    2. the shipped istft trio ``pretrained_istft.npz`` ("distilled-istft"),
       unless ``EGREGORA_FLASHSR_VARIANT=hifigan``;
    3. the shipped HiFi-GAN trio ``pretrained.npz`` ("distilled");
    4. the full config with no weights ("random": the pipeline draws
       them from ``seed``)."""
    converted = load_converted_flashsr()
    if converted is not None:
        return converted[0], converted[1], "converted"
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
