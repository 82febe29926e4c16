"""Eval Pack nodes: ABX, Loudness Meter, Gain Match, Metrics, Resampler.

Counterpart of ``egregora_tpu/nodes/eval_pack.py``: the same node keys,
``INPUT_TYPES``, ``RETURN_TYPES``/``RETURN_NAMES`` and DICT metric keys.
The compute cores are ``eval/``; the nodes coerce at the host boundary
and run on ``DEVICE``, the card unless a caller sets ``"cpu"`` (on the
card every K-weighting goes through the K4 kernel).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

from ..core.audio import from_any
from ..eval.loudness import loudness_report
from ..eval.metrics import lsd_sisdr_report
from ..eval.nulltest import gain_match as _gain_match
from ..ops.resample import resample, resample_linear
from .base import DeviceNode, comfy_audio, host


# -----------------------------
# ABX double-blind pair
# -----------------------------
@dataclass
class ABXMeta:
    x_is: str
    seed: int

    def to_dict(self) -> Dict[str, Any]:
        return {"x_is": self.x_is, "seed": int(self.seed)}


class ABX_Prepare:
    CATEGORY = "Egregora/Listening"
    RETURN_TYPES = ("AUDIO", "AUDIO", "AUDIO", "DICT")
    RETURN_NAMES = ("audio_A", "audio_B", "audio_X", "abx_meta")
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_A": ("AUDIO", {}),
                "audio_B": ("AUDIO", {}),
            },
            "optional": {
                "clip_seconds": ("FLOAT", {"default": 10.0, "min": 1.0, "max": 60.0, "step": 0.1}),
                "random_seed": ("INT", {"default": 0, "min": 0, "max": 2**31 - 1, "step": 1}),
                "start_seconds": ("FLOAT", {"default": 0.0, "min": 0.0, "max": 10_000.0, "step": 0.1}),
            },
        }

    @staticmethod
    def _clip(cn: np.ndarray, sr: int, start_s: float, dur_s: float) -> np.ndarray:
        s = int(round(start_s * sr))
        n = int(round(dur_s * sr))
        if s + n > cn.shape[1]:
            n = max(0, cn.shape[1] - s)
        return cn[:, s: s + n]

    def execute(self, audio_A, audio_B, clip_seconds=10.0, random_seed=0,
                start_seconds=0.0):
        # host-side slicing and a coin flip: no device work
        a, b = from_any(audio_A), from_any(audio_B)
        a_np, b_np = a.numpy(), b.numpy()
        n = min(a_np.shape[1], b_np.shape[1])
        a_c = self._clip(a_np[:, :n], a.sample_rate, start_seconds, clip_seconds)
        b_c = self._clip(b_np[:, :n], b.sample_rate, start_seconds, clip_seconds)
        x_is = random.Random(int(random_seed)).choice(["A", "B"])
        x_c = a_c if x_is == "A" else b_c
        meta = ABXMeta(x_is=x_is, seed=int(random_seed)).to_dict()
        return (comfy_audio(a.sample_rate, a_c, a.meta),
                comfy_audio(b.sample_rate, b_c, b.meta),
                comfy_audio(a.sample_rate if x_is == "A" else b.sample_rate, x_c),
                meta)


class ABX_Judge:
    CATEGORY = "Egregora/Listening"
    RETURN_TYPES = ("DICT",)
    RETURN_NAMES = ("abx_result",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "abx_meta": ("DICT", {}),
                "guess": (["A", "B"], {}),
            },
        }

    def execute(self, abx_meta, guess):
        x_is = str(abx_meta.get("x_is", "?")).upper()
        return ({"x_is": x_is, "guess": guess.upper(), "correct": bool(guess.upper() == x_is)},)


# -----------------------------
# Loudness Meter
# -----------------------------
class Loudness_Meter_1770(DeviceNode):
    CATEGORY = "Egregora/Analysis"
    RETURN_TYPES = ("DICT",)
    RETURN_NAMES = ("metrics",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {"audio": ("AUDIO", {})},
            "optional": {
                "compute_true_peak": ("BOOLEAN", {"default": True}),
                "oversample": ("INT", {"default": 4, "min": 1, "max": 8, "step": 1}),
            },
        }

    def execute(self, audio, compute_true_peak=True, oversample=4):
        cn, sr, _ = self._coerced(audio)
        rep = loudness_report(cn, sr, compute_true_peak=bool(compute_true_peak),
                              oversample=int(oversample))
        return ({k: float(v) for k, v in rep.items()},)


# -----------------------------
# Gain Match
# -----------------------------
class Audio_Gain_Match_1770(DeviceNode):
    CATEGORY = "Egregora/Analysis"
    RETURN_TYPES = ("AUDIO", "FLOAT", "FLOAT", "FLOAT")
    RETURN_NAMES = ("audio_matched", "gain_db", "ref_level", "in_level")
    FUNCTION = "execute"
    MAX_GAIN_MIN = -60.0  # the eval pack's widget range; the null suite's twin has its own

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_ref": ("AUDIO", {}),
                "audio_in": ("AUDIO", {}),
            },
            "optional": {
                "mode": (["LUFS-I", "RMS"], {}),
                "max_gain_db": ("FLOAT", {"default": 12.0, "min": cls.MAX_GAIN_MIN,
                                          "max": -cls.MAX_GAIN_MIN, "step": 0.1}),
            },
        }

    def execute(self, audio_ref, audio_in, mode="LUFS-I", max_gain_db=12.0):
        ref_cn, sr, _ = self._coerced(audio_ref)
        in_cn, in_sr, in_meta = self._coerced(audio_in)
        if in_sr != sr:
            in_cn = resample_linear(in_cn, in_sr, sr)   # the reference's linear interp
        matched, gain_db, ref_lvl, in_lvl = _gain_match(
            ref_cn, in_cn, sr, mode=str(mode), max_gain_db=float(max_gain_db))
        out = comfy_audio(sr, host(matched), in_meta)
        return (out, float(gain_db), float(ref_lvl), float(in_lvl))


# -----------------------------
# Metrics
# -----------------------------
class Metrics_LSD_SISDR(DeviceNode):
    CATEGORY = "Egregora/Analysis"
    RETURN_TYPES = ("DICT",)
    RETURN_NAMES = ("metrics",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_ref": ("AUDIO", {}),
                "audio_proc": ("AUDIO", {}),
            },
            "optional": {
                "n_fft": ("INT", {"default": 2048, "min": 512, "max": 8192, "step": 128}),
                "hop": ("INT", {"default": 512, "min": 64, "max": 4096, "step": 64}),
                "compute_lsd": ("BOOLEAN", {"default": True}),
                "compute_si_sdr": ("BOOLEAN", {"default": True}),
            },
        }

    def execute(self, audio_ref, audio_proc, n_fft=2048, hop=512,
                compute_lsd=True, compute_si_sdr=True):
        am = self._coerced(audio_ref)[0].mean(0)
        bm = self._coerced(audio_proc)[0].mean(0)
        n = min(am.shape[0], bm.shape[0])
        out = lsd_sisdr_report(am[:n], bm[:n], n_fft=int(n_fft), hop=int(hop),
                               compute_lsd=bool(compute_lsd),
                               compute_si_sdr=bool(compute_si_sdr))
        return ({k: float(v) for k, v in out.items()},)


# -----------------------------
# HQ Resampler
# -----------------------------
class Resample_Audio_HQ(DeviceNode):
    CATEGORY = "Egregora/Utils"
    RETURN_TYPES = ("AUDIO",)
    RETURN_NAMES = ("audio_out",)
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        modes = ["auto", "scipy_polyphase", "torchaudio", "linear"]
        return {
            "required": {
                "audio": ("AUDIO", {}),
                "target_sr": ("INT", {"default": 48000, "min": 4000, "max": 384000, "step": 1}),
            },
            "optional": {
                "mode": (modes, {}),
                "kaiser_beta": ("FLOAT", {"default": 14.769, "min": 5.0, "max": 20.0, "step": 0.1}),
            },
        }

    def execute(self, audio, target_sr=48000, mode="auto", kaiser_beta=14.769):
        cn, sr, meta = self._coerced(audio)
        if sr == int(target_sr):
            return (comfy_audio(sr, host(cn), meta),)
        y = resample(cn, sr, int(target_sr), mode=str(mode), beta=float(kaiser_beta))
        return (comfy_audio(int(target_sr), host(y), meta),)


NODE_CLASS_MAPPINGS = {
    "ABX Prepare": ABX_Prepare,
    "ABX Judge": ABX_Judge,
    "Loudness Meter (BS1770)": Loudness_Meter_1770,
    "Audio Gain Match (1770)": Audio_Gain_Match_1770,
    "Metrics (LSD + SI-SDR)": Metrics_LSD_SISDR,
    "Resample Audio (HQ)": Resample_Audio_HQ,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "ABX Prepare": "Egregora ABX Prepare",
    "ABX Judge": "Egregora ABX Judge",
    "Loudness Meter (BS1770)": "Egregora Loudness Meter (BS1770)",
    "Audio Gain Match (1770)": "Egregora Audio Gain Match (1770)",
    "Metrics (LSD + SI-SDR)": "Egregora Metrics (LSD + SI-SDR)",
    "Resample Audio (HQ)": "Egregora Resample Audio (HQ)",
}
