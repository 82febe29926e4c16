"""Spectral Enhance ("Fat Llama") nodes: the ``EgregoraFatLlamaGPU`` and
``EgregoraFatLlamaCPU`` keys.

Counterpart of ``egregora_tpu/nodes/spectral_enhance.py``, with the same
widgets, display names and input surface: an AUDIO dict, an ``(array,
sr)`` pair, a file path (``utils.wavio.read_audio``) or a URL (fetched
with ``requests``, imported only on that branch).  One engine,
``ops.spectral.spectral_enhance``, serves both keys: the GPU node runs it
on ``DEVICE`` (the card unless a caller sets ``"cpu"``), with the
fold-domain loop (``use_matmul_fft=True``) off the CPU as the JAX node
runs it off the CPU; the CPU node is pinned to the CPU with the
per-iteration loop, as the JAX one is.
"""
from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..core.audio import to_cs
from ..ops.spectral import spectral_enhance, upscale_factor
from .base import DeviceNode, comfy_audio, host

FUNCTION = "run"
CATEGORY = "Egregora/Audio"


def _normalize_audio_input(AUDIO=None, audio_path: str = "",
                           audio_url: str = "") -> Tuple[np.ndarray, int]:
    """AUDIO dict / (arr, sr) / path / URL -> ([C, S] float32, sr)."""
    from ..utils.wavio import read_audio

    if isinstance(AUDIO, dict) and "waveform" in AUDIO and "sample_rate" in AUDIO:
        wf = AUDIO["waveform"]
        wf = np.asarray(wf.detach().cpu().numpy() if hasattr(wf, "detach") else wf)
        if wf.ndim == 3:
            wf = wf[0]
        if wf.ndim != 2:
            raise RuntimeError(f"Unexpected AUDIO tensor shape: {wf.shape} (want [C,T])")
        return wf.astype(np.float32), int(AUDIO["sample_rate"])
    if isinstance(AUDIO, (list, tuple)) and len(AUDIO) == 2:
        arr, sr = AUDIO
        return to_cs(arr), int(sr)
    if audio_path:
        p = Path(audio_path)
        if not p.exists():
            raise RuntimeError(f"audio_path not found: {audio_path}")
        y, sr = read_audio(p)
        return to_cs(y), sr
    if audio_url:
        import requests
        r = requests.get(audio_url, timeout=60)
        r.raise_for_status()
        with tempfile.TemporaryDirectory() as d:
            p = Path(d) / "eg_url.wav"
            p.write_bytes(r.content)
            y, sr = read_audio(p)
        return to_cs(y), sr
    raise RuntimeError("No AUDIO provided.")


def _run_engine(cs: np.ndarray, sr: int, max_iterations: int, threshold_value: float,
                target_bitrate_kbps: int, toggle_normalize: bool,
                toggle_autoscale: bool, device: str) -> Tuple[np.ndarray, int]:
    factor = upscale_factor(sr, cs.shape[0], int(target_bitrate_kbps))
    x = torch.from_numpy(np.ascontiguousarray(cs, np.float32)).to(device)
    y = spectral_enhance(x, factor, int(max_iterations), float(threshold_value),
                         toggle_normalize=bool(toggle_normalize),
                         toggle_autoscale=bool(toggle_autoscale),
                         use_matmul_fft=x.device.type != "cpu")
    return host(y), sr * factor


class EgregoraFatLlamaGPU(DeviceNode):
    """Spectral Enhance on the card (the reference GPU node's signature,
    with the normalize/autoscale toggles)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "target_format": (["wav", "flac"],),
                "max_iterations": ("INT", {"default": 300, "min": 1, "max": 5000}),
                "threshold_value": ("FLOAT", {"default": 0.6, "min": 0.0, "max": 1.0, "step": 0.01}),
                "target_bitrate_kbps": ("INT", {"default": 1411, "min": 64, "max": 5000}),
                "toggle_normalize": ("BOOLEAN", {"default": True}),
                "toggle_autoscale": ("BOOLEAN", {"default": True}),
            },
            "optional": {
                "AUDIO": ("AUDIO",),
                "audio_path": ("STRING", {"default": ""}),
                "audio_url": ("STRING", {"default": ""}),
            },
        }

    RETURN_TYPES = ("AUDIO",)
    FUNCTION = FUNCTION
    CATEGORY = CATEGORY
    OUTPUT_NODE = False

    def run(self, target_format, max_iterations, threshold_value,
            target_bitrate_kbps, toggle_normalize=True, toggle_autoscale=True,
            AUDIO=None, audio_path="", audio_url=""):
        cs, sr = _normalize_audio_input(AUDIO, audio_path, audio_url)
        y, out_sr = _run_engine(cs, sr, max_iterations, threshold_value,
                                target_bitrate_kbps, toggle_normalize,
                                toggle_autoscale, self.DEVICE)
        return (comfy_audio(out_sr, y),)


EgregoraFatLlamaTPU = EgregoraFatLlamaGPU    # the JAX package's class name


class EgregoraFatLlamaCPU(EgregoraFatLlamaGPU):
    """Spectral Enhance pinned to the CPU (the reference CPU node's
    signature: no toggles, default 800 iterations; normalize on,
    autoscale off)."""

    DEVICE = "cpu"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "target_format": (["wav", "flac"],),
                "max_iterations": ("INT", {"default": 800, "min": 1, "max": 10000}),
                "threshold_value": ("FLOAT", {"default": 0.6, "min": 0.0, "max": 1.0, "step": 0.01}),
                "target_bitrate_kbps": ("INT", {"default": 1411, "min": 64, "max": 5000}),
            },
            "optional": {
                "AUDIO": ("AUDIO",),
                "audio_path": ("STRING", {"default": ""}),
                "audio_url": ("STRING", {"default": ""}),
            },
        }

    def run(self, target_format, max_iterations, threshold_value,
            target_bitrate_kbps, AUDIO=None, audio_path="", audio_url=""):
        cs, sr = _normalize_audio_input(AUDIO, audio_path, audio_url)
        y, out_sr = _run_engine(cs, sr, max_iterations, threshold_value,
                                target_bitrate_kbps, True, False, self.DEVICE)
        return (comfy_audio(out_sr, y),)


NODE_CLASS_MAPPINGS = {
    "EgregoraFatLlamaGPU": EgregoraFatLlamaGPU,
    "EgregoraFatLlamaCPU": EgregoraFatLlamaCPU,
}
NODE_DISPLAY_NAME_MAPPINGS = {
    "EgregoraFatLlamaGPU": "🎛️ Spectral Enhance (Fat Llama — TPU)",
    "EgregoraFatLlamaCPU": "🎛️ Spectral Enhance (Fat Llama — CPU/XLA)",
}
