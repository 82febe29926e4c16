"""AudioBuffer: the port's audio container, on torch tensors.

Counterpart of ``egregora_tpu/core/audio.py``.  Samples are ``[C, S]``
float32, channels first, as a torch tensor on any device or as host
numpy (so the dispatch edge can choose the transfer format); an
``int16`` tensor is the pcm16 wire output of ``FlashSRPipeline.process``
and ``numpy()`` dequantizes it.

Shape coercion follows the reference node pack:

* ``normalize_cn``: squeeze, 1-D -> [1, N], 2-D with more rows than
  columns -> transpose, >2-D -> longest axis last, the rest folded into
  channels;
* ``to_cs``: the ``[S, C]`` detection heuristic (``w <= 8 and h > w``)
  plus a peak clamp to <= 1.0.

``from_any`` coerces every AUDIO-ish object the node layer meets
(comfy AUDIO dicts, ``(array, sr)`` tuples, bare arrays) into an
``AudioBuffer``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

ArrayLike = Union[np.ndarray, torch.Tensor, list, tuple]

_PCM16_SCALE = 32767.0


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def normalize_cn(arr: ArrayLike) -> np.ndarray:
    """Coerce arbitrary shapes to channels-first ``[C, N]`` float32."""
    a = np.squeeze(np.asarray(_to_numpy(arr)))
    if a.ndim == 0:
        a = a.reshape(1, 1)
    elif a.ndim == 1:
        a = a[None, :]
    elif a.ndim == 2:
        if a.shape[0] > a.shape[1]:
            a = a.T
    else:
        a = np.moveaxis(a, int(np.argmax(a.shape)), -1)
        a = a.reshape(int(np.prod(a.shape[:-1])), a.shape[-1])
    return np.ascontiguousarray(a, dtype=np.float32)


def to_cs(arr: ArrayLike, clamp_peak: bool = True) -> np.ndarray:
    """``[S] | [S,C] | [C,S]`` -> ``[C,S]`` float32, with optional peak clamp."""
    a = np.asarray(_to_numpy(arr), dtype=np.float32)
    if a.ndim == 1:
        a = a[None, :]
    elif a.ndim == 2:
        h, w = a.shape
        if w <= 8 and h > w:  # frames-first (soundfile) -> channels-first
            a = a.T
    else:
        a = a.reshape(-1)[None, :]
    if clamp_peak and a.size:
        m = float(np.max(np.abs(a)))
        if m > 1.0:
            a = a / (m + 1e-8)
    return np.ascontiguousarray(a, dtype=np.float32)


def pcm16_encode(x: ArrayLike) -> np.ndarray:
    """float32 [-1, 1] -> int16 (clipping outside the PCM range)."""
    a = np.asarray(_to_numpy(x), dtype=np.float32)
    return np.rint(np.clip(a, -1.0, 1.0) * _PCM16_SCALE).astype(np.int16)


def pcm16_decode(x: ArrayLike) -> np.ndarray:
    """int16 -> float32 in [-1, 1] (inverse of ``pcm16_encode``)."""
    return np.asarray(_to_numpy(x), dtype=np.float32) / _PCM16_SCALE


@dataclasses.dataclass
class AudioBuffer:
    """Audio ``samples`` [C, S] + sample rate + metadata."""

    samples: Union[torch.Tensor, np.ndarray]
    sample_rate: int
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def channels(self) -> int:
        return int(self.samples.shape[0])

    @property
    def num_samples(self) -> int:
        return int(self.samples.shape[-1])

    @property
    def duration_s(self) -> float:
        """Seconds of audio: samples over rate, whatever the samples' dtype
        (an int16 wire buffer holds one sample per element too)."""
        return self.num_samples / float(self.sample_rate)

    def mono(self) -> Union[torch.Tensor, np.ndarray]:
        """Channel-averaged mono signal ``[S]`` in float32: a tensor on the
        samples' device if they are a tensor, numpy if they are numpy; an
        int16 wire buffer is dequantized first."""
        if isinstance(self.samples, torch.Tensor):
            s = self.samples
            if s.dtype == torch.int16:
                s = torch.from_numpy(self.numpy()).to(s.device)
            return s.float().mean(0)
        return np.mean(self.numpy(), axis=0, dtype=np.float32)

    def with_samples(self, samples: Union[torch.Tensor, np.ndarray],
                     sample_rate: Optional[int] = None,
                     meta: Optional[Dict[str, Any]] = None) -> "AudioBuffer":
        """A new buffer of ``samples``, keeping this one's rate and meta
        unless they are given."""
        return AudioBuffer(
            samples=samples,
            sample_rate=int(sample_rate if sample_rate is not None else self.sample_rate),
            meta=dict(self.meta if meta is None else meta),
        )

    def numpy(self) -> np.ndarray:
        a = _to_numpy(self.samples)
        if a.dtype == np.int16:          # pcm16 wire output
            dec = pcm16_decode(a)
            # outputs above full scale ride the wire divided by
            # meta["wire_scale"] = max(1, peak); multiply back here
            scale = self.meta.get("wire_scale")
            if scale is not None:
                s = float(_to_numpy(scale))
                if s != 1.0:
                    dec = dec * np.float32(s)
            return dec
        return a

    def to_comfy(self) -> Dict[str, Any]:
        """The reference node contract: waveform [1, C, T] + sample_rate."""
        s = self.numpy().astype(np.float32)
        return {"waveform": s[None, ...], "sample_rate": int(self.sample_rate),
                "sr": int(self.sample_rate), "samples": s, "meta": dict(self.meta)}



def make_audio(sr: int, samples_cn: ArrayLike, meta: Optional[dict] = None) -> AudioBuffer:
    """An ``AudioBuffer`` of host numpy samples from any array shape
    (``normalize_cn``), so the pipeline's dispatch edge chooses the
    transfer format."""
    return AudioBuffer(normalize_cn(samples_cn), int(sr), dict(meta or {}))


def from_any(x: Any) -> AudioBuffer:
    """Any AUDIO-ish object -> ``AudioBuffer`` of host samples, in the
    JAX package's order:

    * an ``AudioBuffer`` (passed through);
    * a dict with ``waveform`` and one of ``sample_rate``/``sr``/``rate``
      (a true ``[B, C, T]`` batch, B > 1, folds onto the channel axis and
      records ``meta["batch"]``, which ``nodes.base.comfy_audio`` undoes);
    * a dict with ``samples``/``audio``/``array`` and ``sr``/``sample_rate``;
    * an ``(array, sr)`` pair (frames-first ``[S, C]`` with C <= 8 transposed);
    * a bare array or tensor (48 kHz assumed)."""
    if isinstance(x, AudioBuffer):
        return x
    if isinstance(x, dict) and "waveform" in x and any(k in x for k in ("sample_rate", "sr", "rate")):
        sr = int(x.get("sample_rate") or x.get("sr") or x.get("rate"))
        wf = _to_numpy(x["waveform"])
        meta = dict(x.get("meta", {}))
        if wf.ndim == 3:
            b, c = int(wf.shape[0]), int(wf.shape[1])
            if b > 1:
                meta["batch"] = b
                wf = wf.reshape(b * c, wf.shape[-1])
            else:
                wf = wf[0]
        return make_audio(sr, wf, meta)
    if isinstance(x, dict) and ("sr" in x or "sample_rate" in x):
        sr = int(x.get("sr") or x.get("sample_rate"))
        buf = next((x[k] for k in ("samples", "audio", "array") if x.get(k) is not None), None)
        if buf is None:
            raise ValueError("Audio dict missing samples/waveform")
        return make_audio(sr, buf, x.get("meta", {}))
    if isinstance(x, (list, tuple)) and len(x) == 2 and not isinstance(x[0], (int, float)):
        arr, sr = x
        arr = _to_numpy(arr)
        if arr.ndim == 1:
            cs = arr[None, :]
        elif arr.ndim == 2:
            cs = arr.T if arr.shape[0] >= arr.shape[1] and arr.shape[1] <= 8 else arr
        else:
            cs = arr.reshape(1, -1)
        return AudioBuffer(np.ascontiguousarray(cs, dtype=np.float32), int(sr), {})
    if isinstance(x, (np.ndarray, torch.Tensor)):
        arr = _to_numpy(x)
        if arr.ndim == 3:
            arr = arr[0]
        return make_audio(48000, arr, {})
    raise ValueError(f"Unsupported AUDIO object: {type(x)!r}")
