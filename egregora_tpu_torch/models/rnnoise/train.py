"""The shipped RNNoise weights: counterpart of ``pretrained_path`` and
``load_pretrained`` in ``egregora_tpu/models/rnnoise/train.py``.

The JAX package ships its synthetic-distilled weights as
``egregora_tpu/models/rnnoise/pretrained.npz`` (its ``save_params``
format); the port reads that file in place.  The trainer itself is not
ported.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

SHIPPED = (Path(__file__).resolve().parents[3] / "egregora_tpu" / "models" / "rnnoise"
           / "pretrained.npz")


def pretrained_path() -> Path:
    return SHIPPED


def load_pretrained() -> Dict | None:
    """The shipped weights as a nested dict of numpy arrays, or None
    where the file is missing."""
    p = pretrained_path()
    if not p.exists():
        return None
    from ...utils.weights import load_params
    return load_params(p)
