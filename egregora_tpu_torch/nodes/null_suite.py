"""Null Test Suite nodes: Align, Gain Match, Null Test, Plotter, Full.

Counterpart of ``egregora_tpu/nodes/null_suite.py``: the same node keys,
widgets and return tuples, and "Null Test (Full)" composed from the other
four nodes as the reference composes it.  Compute runs on ``DEVICE``
(``nodes.base.DeviceNode``, the card unless a caller sets ``"cpu"``);
the figures are host-side matplotlib.
"""
from __future__ import annotations

import numpy as np
import torch

from ..eval.align import apply_frac_delay, pad_or_crop, peak_correlation, xcorr_delay_curve
from ..eval.nulltest import gain_match as _gain_match
from ..eval.nulltest import null_test as _null_test
from ..ops.resample import resample_linear
from ..ops.stft import stft_mag
from .base import DeviceNode, blank_image, comfy_audio, host, image_from_figure


# -----------------------------
# Node 1: Audio Align (XCorr)
# -----------------------------
class Audio_Align_XCorr(DeviceNode):
    CATEGORY = "Egregora/Analysis"
    RETURN_TYPES = ("AUDIO", "FLOAT", "FLOAT", "FLOAT", "IMAGE")
    RETURN_NAMES = ("audio_proc_aligned", "delay_samples", "delay_ms",
                    "peak_corr", "debug_image")
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_ref": ("AUDIO", {}),
                "audio_proc": ("AUDIO", {}),
            },
            "optional": {
                "max_shift_ms": ("INT", {"default": 200, "min": 0, "max": 5000, "step": 1}),
                # "gcc-phat" = reference-exact (includes its 1-sample
                # center bias); "gcc-phat-fixed" corrects the bias
                "align_method": (["gcc-phat", "gcc-phat-fixed"], {}),
                "fractional": ("BOOLEAN", {"default": True}),
                "fir_len": ("INT", {"default": 64, "min": 16, "max": 256, "step": 1}),
            },
        }

    def execute(self, audio_ref, audio_proc, max_shift_ms=200,
                align_method="gcc-phat", fractional=True, fir_len=64):
        ref_cn, sr, _ = self._coerced(audio_ref)
        proc_cn, proc_sr, proc_meta = self._coerced(audio_proc)
        if proc_sr != sr:
            proc_cn = resample_linear(proc_cn, proc_sr, sr)

        a = ref_cn.mean(0)
        b = proc_cn.mean(0)
        n = min(a.shape[0], b.shape[0])
        a, b = a[:n], b[:n]

        fixed = align_method == "gcc-phat-fixed"
        max_shift = int(sr * (max_shift_ms / 1000.0))
        lag, curve = xcorr_delay_curve(a, b, max_shift, bias_fix=fixed)
        delay_samples = float(lag)
        delay_ms = 1000.0 * delay_samples / sr
        # the reference's peak_corr is a constant 0.0; the fixed method
        # reports the waveform correlation at the found lag
        pk = float(peak_correlation(a, b, lag)) if fixed else 0.0

        shift = -lag if fractional else torch.round(-lag)
        aligned = apply_frac_delay(proc_cn, shift, taps=int(fir_len))
        aligned = pad_or_crop(aligned, ref_cn.shape[1])
        out = comfy_audio(sr, host(aligned), proc_meta)

        try:   # the reference's contract: a blank image when no figure can be drawn
            from ..utils.viz import alignment_figure
            lags_ms = (np.arange(-max_shift, max_shift + 1) + (1 if fixed else 0)
                       ) * 1000.0 / sr
            debug_img = image_from_figure(
                alignment_figure(host(curve), lags_ms, delay_ms, pk))
        except Exception:
            debug_img = blank_image()

        return (out, float(delay_samples), float(delay_ms), pk, debug_img)


# -----------------------------
# Node 2: Audio Gain Match
# -----------------------------
class Audio_Gain_Match(DeviceNode):
    CATEGORY = "Egregora/Analysis"
    RETURN_TYPES = ("AUDIO", "FLOAT", "FLOAT", "FLOAT")
    RETURN_NAMES = ("audio_matched", "gain_db", "ref_level", "in_level")
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_ref": ("AUDIO", {}),
                "audio_in": ("AUDIO", {}),
            },
            "optional": {
                "mode": (["LUFS-I", "RMS"], {}),
                "max_gain_db": ("FLOAT", {"default": 12.0, "min": -48.0, "max": 48.0, "step": 0.1}),
            },
        }

    def execute(self, audio_ref, audio_in, mode="LUFS-I", max_gain_db=12.0):
        ref_cn, sr, _ = self._coerced(audio_ref)
        in_cn, in_sr, in_meta = self._coerced(audio_in)
        if in_sr != sr:
            in_cn = resample_linear(in_cn, in_sr, sr)
        matched, gain_db, ref_lvl, in_lvl = _gain_match(
            ref_cn, in_cn, sr, mode=str(mode), max_gain_db=float(max_gain_db))
        out = comfy_audio(sr, host(matched), in_meta)
        return (out, float(gain_db), float(ref_lvl), float(in_lvl))


# -----------------------------
# Node 3: Audio Null Test
# -----------------------------
class Audio_Null_Test(DeviceNode):
    CATEGORY = "Egregora/Analysis"
    RETURN_TYPES = ("AUDIO", "DICT")
    RETURN_NAMES = ("audio_null", "metrics")
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_ref": ("AUDIO", {}),
                "audio_proc_aligned_matched": ("AUDIO", {}),
            },
            "optional": {
                "invert_b": ("BOOLEAN", {"default": True}),
                "least_squares_scale": ("BOOLEAN", {"default": False}),
                "compute_corr": ("BOOLEAN", {"default": True}),
                "compute_null_rms": ("BOOLEAN", {"default": True}),
                "compute_null_lufs": ("BOOLEAN", {"default": True}),
                "compute_lsd": ("BOOLEAN", {"default": True}),
                "compute_hf_residual": ("BOOLEAN", {"default": False}),
                "n_fft": ("INT", {"default": 2048, "min": 512, "max": 8192, "step": 128}),
                "hop": ("INT", {"default": 512, "min": 64, "max": 4096, "step": 64}),
                "hf_band_hz": ("INT", {"default": 8000, "min": 1000, "max": 20000, "step": 100}),
            },
        }

    def execute(self, audio_ref, audio_proc_aligned_matched, invert_b=True,
                least_squares_scale=False, compute_corr=True, compute_null_rms=True,
                compute_null_lufs=True, compute_lsd=True, compute_hf_residual=False,
                n_fft=2048, hop=512, hf_band_hz=8000):
        ref_cn, sr, _ = self._coerced(audio_ref)
        pro_cn, pro_sr, _ = self._coerced(audio_proc_aligned_matched)
        if pro_sr != sr:
            raise ValueError("Sample rate mismatch after alignment stage")
        n = min(ref_cn.shape[1], pro_cn.shape[1])
        null, metrics = _null_test(
            ref_cn[:, :n], pro_cn[:, :n], sr,
            invert_b=bool(invert_b), least_squares_scale=bool(least_squares_scale),
            compute_corr=bool(compute_corr), compute_null_rms=bool(compute_null_rms),
            compute_null_lufs=bool(compute_null_lufs), compute_lsd=bool(compute_lsd),
            compute_hf_residual=bool(compute_hf_residual), n_fft=int(n_fft),
            hop=int(hop), hf_band_hz=int(hf_band_hz))
        metrics = {k: (int(v) if k == "overshoot_count" else float(v))
                   for k, v in metrics.items()}
        return (comfy_audio(sr, host(null), {}), metrics)


# -----------------------------
# Node 4: Audio Plotter
# -----------------------------
class Audio_Plotter(DeviceNode):
    CATEGORY = "Egregora/Visualization"
    RETURN_TYPES = ("IMAGE", "IMAGE", "IMAGE")
    RETURN_NAMES = ("image_waveforms", "image_spectrograms", "image_diffspec")
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_ref": ("AUDIO", {}),
                "audio_proc": ("AUDIO", {}),
                "audio_null": ("AUDIO", {}),
            },
            "optional": {
                "draw_waveforms": ("BOOLEAN", {"default": True}),
                "draw_spectrograms": ("BOOLEAN", {"default": True}),
                "draw_diffspec": ("BOOLEAN", {"default": True}),
                "n_fft": ("INT", {"default": 2048, "min": 512, "max": 8192, "step": 128}),
                "hop": ("INT", {"default": 512, "min": 64, "max": 4096, "step": 64}),
            },
        }

    def execute(self, audio_ref, audio_proc, audio_null, draw_waveforms=True,
                draw_spectrograms=True, draw_diffspec=True, n_fft=2048, hop=512):
        # imports matplotlib's figures module lazily: a missing matplotlib
        # raises here, as the reference's plotter does
        from ..utils.viz import difference_figure, spectrogram_figure, waveform_figure

        ref_cn, sr, _ = self._coerced(audio_ref)
        pro_cn = self._coerced(audio_proc)[0]
        nul_cn = self._coerced(audio_null)[0]

        a = ref_cn.mean(0)
        b = pro_cn.mean(0)
        n = int(min(a.shape[0], b.shape[0], nul_cn.shape[1]))
        a, b, null = a[:n], b[:n], nul_cn.mean(0)[:n]
        names = ("A (ref)", "B (proc)", "null")

        if draw_waveforms:
            img_wave = image_from_figure(waveform_figure(
                dict(zip(names, (host(a), host(b), host(null)))), sr))
        else:
            img_wave = blank_image(1, 1)

        def _spec_db(y):
            # spectrogram data computed on the device, drawn on the host
            return 20.0 * np.log10(host(stft_mag(y, int(n_fft), int(hop))) + 1e-9)

        if draw_spectrograms:
            img_spec = image_from_figure(spectrogram_figure(
                dict(zip(names, map(_spec_db, (a, b, null)))), sr, int(hop)))
        else:
            img_spec = blank_image(1, 1)

        if draw_diffspec:
            img_diff = image_from_figure(difference_figure(
                _spec_db(a), _spec_db(b), sr, int(hop)))
        else:
            img_diff = blank_image(1, 1)

        return (img_wave, img_spec, img_diff)


# -----------------------------
# Node 5: Null Test (Full)
# -----------------------------
class Null_Test_Full:
    CATEGORY = "Egregora/Analysis"
    RETURN_TYPES = ("AUDIO", "AUDIO", "FLOAT", "FLOAT", "DICT", "IMAGE", "IMAGE", "IMAGE")
    RETURN_NAMES = (
        "audio_proc_aligned_matched",
        "audio_null",
        "delay_ms",
        "gain_db",
        "metrics",
        "image_waveforms",
        "image_spectrograms",
        "image_diffspec",
    )
    FUNCTION = "execute"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio_ref": ("AUDIO", {}),
                "audio_proc": ("AUDIO", {}),
            },
            "optional": {
                "align_max_shift_ms": ("INT", {"default": 200, "min": 0, "max": 5000, "step": 1}),
                "align_method": (["gcc-phat", "gcc-phat-fixed"], {}),
                "fractional": ("BOOLEAN", {"default": True}),
                "fir_len": ("INT", {"default": 64, "min": 16, "max": 256, "step": 1}),
                "match_mode": (["LUFS-I", "RMS"], {}),
                "least_squares_scale": ("BOOLEAN", {"default": False}),
                "compute_corr": ("BOOLEAN", {"default": True}),
                "compute_null_rms": ("BOOLEAN", {"default": True}),
                "compute_null_lufs": ("BOOLEAN", {"default": True}),
                "compute_lsd": ("BOOLEAN", {"default": True}),
                "compute_hf_residual": ("BOOLEAN", {"default": False}),
                "draw_waveforms": ("BOOLEAN", {"default": True}),
                "draw_spectrograms": ("BOOLEAN", {"default": True}),
                "draw_diffspec": ("BOOLEAN", {"default": True}),
                "n_fft": ("INT", {"default": 2048, "min": 512, "max": 8192, "step": 128}),
                "hop": ("INT", {"default": 512, "min": 64, "max": 4096, "step": 64}),
            },
        }

    def execute(self, audio_ref, audio_proc, align_max_shift_ms=200,
                align_method="gcc-phat", fractional=True, fir_len=64,
                match_mode="LUFS-I", least_squares_scale=False, compute_corr=True,
                compute_null_rms=True, compute_null_lufs=True, compute_lsd=True,
                compute_hf_residual=False, draw_waveforms=True,
                draw_spectrograms=True, draw_diffspec=True, n_fft=2048, hop=512):
        # the other four nodes as a library, as the reference composes them
        ap_aligned, _d_smp, delay_ms, _pc, _dbg = Audio_Align_XCorr().execute(
            audio_ref, audio_proc, max_shift_ms=align_max_shift_ms,
            align_method=align_method, fractional=fractional, fir_len=fir_len)
        ap_matched, gain_db, _r, _i = Audio_Gain_Match().execute(
            audio_ref, ap_aligned, mode=match_mode)
        audio_null, metrics = Audio_Null_Test().execute(
            audio_ref, ap_matched, invert_b=True,
            least_squares_scale=least_squares_scale, compute_corr=compute_corr,
            compute_null_rms=compute_null_rms, compute_null_lufs=compute_null_lufs,
            compute_lsd=compute_lsd, compute_hf_residual=compute_hf_residual,
            n_fft=n_fft, hop=hop)
        img_waves, img_spec, img_diff = Audio_Plotter().execute(
            audio_ref, ap_matched, audio_null, draw_waveforms=draw_waveforms,
            draw_spectrograms=draw_spectrograms, draw_diffspec=draw_diffspec,
            n_fft=n_fft, hop=hop)
        return (ap_matched, audio_null, float(delay_ms), float(gain_db),
                metrics, img_waves, img_spec, img_diff)


NODE_CLASS_MAPPINGS = {
    "Audio Align (XCorr)": Audio_Align_XCorr,
    "Audio Gain Match": Audio_Gain_Match,
    "Audio Null Test": Audio_Null_Test,
    "Audio Plotter": Audio_Plotter,
    "Null Test (Full)": Null_Test_Full,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "Audio Align (XCorr)": "Audio Align (XCorr)",
    "Audio Gain Match": "Audio Gain Match",
    "Audio Null Test": "Audio Null Test",
    "Audio Plotter": "Audio Plotter",
    "Null Test (Full)": "Null Test (Full)",
}
