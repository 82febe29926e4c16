"""Node-layer interop: comfy-style AUDIO dicts at the host boundary.

Counterpart of the AUDIO half of ``egregora_tpu/nodes/base.py``: inputs
are coerced through ``core.audio.from_any``; returned AUDIO dicts carry
a CPU ``waveform`` tensor ``[1, C, T]`` (the reference contract) plus the
eval pack's extended keys (``sr``, ``samples``, ``meta``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.audio import AudioBuffer, from_any, normalize_cn


def to_buffer(x: Any) -> AudioBuffer:
    """Host-side samples, so the pipeline's dispatch edge can transfer
    them in the pcm16 wire format."""
    return from_any(x)


def comfy_audio(sr: int, samples_cn: Any, meta: Optional[dict] = None) -> Dict[str, Any]:
    """Extended AUDIO dict; a ``[B, C, T]`` batch folded by ``from_any``
    (``meta["batch"] = B > 1``) is unfolded again."""
    s = normalize_cn(samples_cn)
    meta = dict(meta or {})
    b = int(meta.get("batch", 1) or 1)
    if b > 1 and s.shape[0] % b == 0:
        arr = np.ascontiguousarray(s).reshape(b, s.shape[0] // b, s.shape[1])
    else:
        arr = np.ascontiguousarray(s)[None, ...]
    return {"sr": int(sr), "sample_rate": int(sr), "samples": s,
            "waveform": torch.from_numpy(arr.copy()), "meta": meta}


def buffer_to_comfy(buf: AudioBuffer) -> Dict[str, Any]:
    return comfy_audio(buf.sample_rate, buf.numpy(), buf.meta)
