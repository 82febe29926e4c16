"""The shipped DAC codecs and the quality-gate metric: counterpart of
``PRETRAINED``, ``load_pretrained`` and ``roundtrip_snr_db`` in
``egregora_tpu/models/dac/train.py``.

The JAX package ships one compact codec per model type,
``egregora_tpu/models/dac/pretrained_{44,24,16}khz.npz``: float16 leaves
(read as float32) and, since round 3, a ``__config__`` entry with the
geometry that trained them; older files without it were trained at one
fixed geometry.  The port reads them in place.  The trainer itself is not
ported.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .model import DACConfig, DACModel

SHIPPED_DIR = Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "dac"
PRETRAINED = {t: SHIPPED_DIR / f"pretrained_{t}.npz" for t in ("44khz", "24khz", "16khz")}

_RATES = {"44khz": 44100, "24khz": 24000, "16khz": 16000}


def load_pretrained(model_type: str = "44khz"):
    """(config, parameter tree of float32 numpy arrays) of the shipped
    compact codec, or None."""
    from ...utils.weights import unflatten

    path = PRETRAINED.get(model_type)
    if path is None or not path.exists():
        return None
    with np.load(path) as z:
        files = list(z.files)
        if "__config__" in files:
            d = json.loads(bytes(z["__config__"].tobytes()).decode())
            d["strides"] = tuple(d["strides"])
            cfg = DACConfig(**d)
            files.remove("__config__")
        else:
            # the round-2 weight sets predate the embedded config
            cfg = DACConfig(sample_rate=_RATES[model_type], encoder_dim=16,
                            strides=(2, 4, 4, 4), decoder_dim=256,
                            n_codebooks=6, codebook_size=1024, codebook_dim=8,
                            res_scale=0.5, output_tanh=False, alpha_floor=0.05)
        params = unflatten({k: z[k].astype(np.float32) for k in files})
    return cfg, params


def roundtrip_snr_db(model: DACModel, wav: np.ndarray) -> float:
    """Codec roundtrip SNR on ``[C, T]`` (the quality-gate metric), on the
    model's device."""
    z_q, _ = model.encode(torch.from_numpy(np.ascontiguousarray(wav, np.float32)))
    rec = model.decode(z_q).cpu().numpy()[:, : wav.shape[-1]]
    err = np.mean(np.square(rec - np.asarray(wav)))
    sig = np.mean(np.square(np.asarray(wav))) + 1e-12
    return float(10.0 * np.log10(sig / (err + 1e-12)))
