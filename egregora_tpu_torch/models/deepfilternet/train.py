"""The shipped DeepFilterNet weights: counterpart of ``pretrained_path``
and ``load_pretrained`` in ``egregora_tpu/models/deepfilternet/train.py``.

The JAX package ships one synthetic-distilled weight set per variant,
``egregora_tpu/models/deepfilternet/pretrained.npz`` (DFN2) and
``pretrained_dfn3.npz`` (DFN3), in its ``save_params`` format; the port
reads them in place.  The trainer itself is not ported.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

SHIPPED_DIR = Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "deepfilternet"


def pretrained_path(variant: str = "DeepFilterNet2") -> Path:
    name = "pretrained.npz" if str(variant) == "DeepFilterNet2" else "pretrained_dfn3.npz"
    return SHIPPED_DIR / name


def load_pretrained(variant: str = "DeepFilterNet2") -> Dict | None:
    """The variant's shipped weights as a nested dict of numpy arrays, or
    None where the file is missing."""
    p = pretrained_path(variant)
    if not p.exists():
        return None
    from ...utils.weights import load_params
    return load_params(p)
