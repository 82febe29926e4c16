"""Node-layer interop: comfy-style AUDIO and IMAGE at the host boundary.

Counterpart of ``egregora_tpu/nodes/base.py``: inputs are coerced
through ``core.audio.from_any``; returned AUDIO dicts carry a CPU
``waveform`` tensor ``[1, C, T]`` (the reference contract) plus the eval
pack's extended keys (``sr``, ``samples``, ``meta``); IMAGE outputs are
CPU float32 tensors ``[1, H, W, 3]`` in 0..1.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

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


class DeviceNode:
    """Base of the eval, null-suite, enhance and upscaler nodes: ``DEVICE`` is where their
    compute runs, the card unless a caller sets ``"cpu"`` (on this class
    for all of them, or on one node class)."""
    DEVICE = "cuda"

    def _coerced(self, x: Any) -> Dict[str, Any]:
        """AUDIO-ish input -> ``{"sr", "cn": [C, N] float32 on DEVICE, "meta"}``."""
        buf = from_any(x)
        cn = torch.from_numpy(np.ascontiguousarray(buf.numpy(), np.float32)).to(self.DEVICE)
        return {"sr": buf.sample_rate, "cn": cn, "meta": dict(buf.meta)}


@contextlib.contextmanager
def node_device(device: Any) -> Iterator[None]:
    """Every node's ``DEVICE`` set to ``device`` ("cuda" or "cpu") for the
    block through ``DeviceNode``, and restored after it, also when a node
    raises (a class that pins its own, as ``EgregoraFatLlamaCPU`` does,
    keeps it)."""
    saved = DeviceNode.DEVICE
    DeviceNode.DEVICE = torch.device(device).type
    try:
        yield
    finally:
        DeviceNode.DEVICE = saved


def host(x: torch.Tensor) -> np.ndarray:
    """A result tensor as host numpy."""
    return x.detach().cpu().numpy()


def blank_image(h: int = 8, w: int = 8) -> torch.Tensor:
    """IMAGE ``[1, H, W, 3]`` of zeros (the reference's ``_blank_image``)."""
    return torch.zeros((1, h, w, 3), dtype=torch.float32)


def image_from_figure(fig) -> torch.Tensor:
    """A matplotlib figure as IMAGE ``[1, H, W, 3]`` in 0..1 (PNG at 110
    dpi, tight bounding box, as the reference rasterizes)."""
    import io

    import matplotlib
    matplotlib.use("Agg")
    from PIL import Image

    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight", dpi=110)
    fig.clf()
    buf.seek(0)
    arr = np.array(Image.open(buf).convert("RGB")).astype(np.float32) / 255.0
    return torch.from_numpy(arr).unsqueeze(0)
