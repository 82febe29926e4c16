"""The system under test: the port's upscaler node with a configuration's
pipeline in its class cache.

``build`` makes the cell's ``FlashSRPipeline`` the way the node's resolver
would serve it, without the resolver's file lookups:

* ``upstream_seeded``: the benchmark's seeded upstream state dicts
  (``weights.upstream_state_dicts``), converted by the port's own name
  maps and ``convert_state_dict`` (the body of
  ``distill.convert_flashsr_trio``, less its write of a cache file) and
  ``params_from_jax``; ``weight_source`` "converted";
* ``npz``: the trio file read in place by ``distill.load_pretrained_with_cfg``;
  ``weight_source`` "distilled-istft".

The pipeline then sits in ``EgregoraAudioSuperResolution._PIPE``, where
the node keeps it between calls, on the card (``DEVICE`` "cuda").
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

from . import weights


def port_config(geometry: Dict):
    """The port's ``FlashSRConfig`` for a geometry in the ``__config__``
    JSON format the trio files carry."""
    from egregora_tpu_torch.models.flashsr.distill import _cfg_from_json
    return _cfg_from_json(json.dumps(geometry))


def build(config: Dict, root: Path, seed: int, device: str = "cuda"):
    """``(pipeline, node)``: the cell's pipeline placed in the node's
    class cache, and a node instance to call."""
    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr.pipeline import FlashSRModules, FlashSRPipeline
    from egregora_tpu_torch.nodes.super_resolution import EgregoraAudioSuperResolution
    from egregora_tpu_torch.utils.weights import (convert_state_dict, flax_tree,
                                                  params_from_jax)

    w = config["weights"]
    if w["kind"] == "upstream_seeded":
        cfg = port_config(config["geometry"])
        sds = weights.upstream_state_dicts(json.dumps(config["geometry"]), w["weight_seed"],
                                           seed, device)
        host = {n: {k: t.cpu().numpy() for k, t in sd.items()} for n, sd in sds.items()}
        del sds
        with torch.device("meta"):
            mods = FlashSRModules(cfg)
        maps = {"vae": distill.audioldm_vae_name_map(cfg.vae),
                "student_ldm": distill.ldm_unet_name_map(cfg.unet),
                "sr_vocoder": distill.hifigan_name_map(cfg.vocoder)}
        tree = {n: convert_state_dict(host[n], flax_tree(m), name_map=maps[n])
                for n, m in mods.by_name().items()}
        pipe = FlashSRPipeline(cfg, params=params_from_jax(cfg, tree), device=device)
        pipe.weight_source = "converted"
    elif w["kind"] == "npz":
        cfg, params = distill.load_pretrained_with_cfg(root / w["path"])
        if json.loads(distill._cfg_to_json(cfg)) != config["geometry"]:
            raise ValueError(f"{w['path']} carries another geometry than the configuration")
        pipe = FlashSRPipeline(cfg, params=params, device=device)
        pipe.weight_source = "distilled-istft"
    else:
        raise ValueError(f"unknown weights kind {w['kind']!r}")
    EgregoraAudioSuperResolution.DEVICE = device
    EgregoraAudioSuperResolution._PIPE = pipe
    return pipe, EgregoraAudioSuperResolution()


def release() -> None:
    """Drop the node's cached pipeline and the device memory it held."""
    import gc

    from egregora_tpu_torch.nodes.super_resolution import EgregoraAudioSuperResolution
    EgregoraAudioSuperResolution._PIPE = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
