"""Enhance Extras nodes: RNNoise, WPE, DeepFilterNet, DAC encode/decode.

Counterpart of ``egregora_tpu/nodes/enhance_extras.py``, with the same
keys, widgets, defaults, display names, categories, return names, log
strings and meta.  Every node runs on ``DEVICE``, the card unless a
caller sets ``"cpu"`` (``nodes.base.DeviceNode``); the ``device`` widget
of the DeepFilterNet and DAC nodes is accepted and ignored, as in the JAX
package.  A ``[B, C, T]`` batch is folded into channels; the
cross-channel steps (the mono downmix, WPE's mic array) run per batch
item.

* RNNoise: resample to 48 kHz, optional per-item mono downmix, the
  denoiser (``models.rnnoise.model.denoise``; ``EGREGORA_RNNOISE_SEGMENTS=N``
  runs its frame recurrence as N warmed-up segments), the VAD pooled over
  ``frame_ms`` / 10 engine frames, the adaptive wet/dry mix
  (``ops.mix``), resample back, post gain and limiter.  With no shipped
  weights it warns and serves random-init parameters, as the JAX node does.
* WPE: ``models.wpe.wpe_dereverb`` per batch item; on an exception it
  warns and passes the input through, as the JAX node does.
* DeepFilterNet: optional per-item mono downmix, then resample to 48 kHz
  (that order, as the JAX node), the variant's shipped weights through
  ``models.deepfilternet.model.enhance`` (all channels in one batch),
  both the wet signal and the 48 kHz input resampled back (the dry
  signal), a VAD per channel (``rms``: ``ops.mix.rms_vad_probs``;
  ``rnnoise``: the RNNoise engine on the channel padded to whole frames;
  ``none``), the adaptive mix on a 10 ms hop at the input rate, post gain
  and limiter.  ``meta["deepfilternet"]["device"]`` is the device it ran on.
* DAC: ``models.dac.model.build_dac`` per model type (cached on the
  encode node's class, which the decode node reads too); encode resamples
  to the codec's rate and returns the JAX node's codes dict
  (``latents [[z [C, T/hop, D]]]``, ``codes [C, n_q, T/hop]``, the two
  rates); decode runs every latent of the dict and resamples back,
  without cropping to the input's length.  Their spans,
  ``egr.node.dac_encode`` and ``egr.node.dac_decode``, each open a call
  id; ``latent_bytes_out`` counts the bytes of the codes dict's host
  copies (latents and codes), ``latent_bytes_in`` those of the latents
  the decode node reads back (``utils.profiling``).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..ops.mix import adaptive_mix, post_gain_limit, rms_vad_probs
from ..ops.resample import resample
from ..utils.profiling import count, span
from .base import DeviceNode, comfy_audio, host

CATEGORY = "Egregora/Enhance"


def _batch_shape(folded_channels: int, meta: dict) -> Tuple[int, int]:
    """``(B, C)`` for a folded ``[B*C, T]`` array."""
    b = int(meta.get("batch", 1) or 1)
    if b > 1 and folded_channels % b == 0:
        return b, folded_channels // b
    return 1, folded_channels


def _downmix_mono(x_bct: torch.Tensor, meta: dict) -> torch.Tensor:
    """Per-item mono downmix of a folded ``[B*C, T]`` array -> ``[B, T]``."""
    b, c = _batch_shape(x_bct.shape[0], meta)
    if b == 1:
        return x_bct.mean(0, keepdim=True)
    return x_bct.reshape(b, c, -1).mean(1)


class Egregora_RNNoise_Denoise(DeviceNode):
    """48 kHz RNNoise-class denoiser with VAD-adaptive wet/dry mix."""

    _PARAMS = None  # class-level weight cache

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio": ("AUDIO",),
                "frame_ms": ("INT", {"default": 20, "min": 5, "max": 60, "step": 5}),
                "stereo_mode": (["per_channel", "downmix_mono"], {"default": "per_channel"}),
                "strength": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 1.0, "step": 0.01}),
                "mix_curve": (["equal_power", "linear"], {"default": "equal_power"}),
                "adaptive_mode": (["off", "more_on_noise", "more_on_speech", "gate_on_noise"],
                                  {"default": "more_on_noise"}),
                "adaptive_amount": ("FLOAT", {"default": 0.5, "min": 0.0, "max": 1.0, "step": 0.01}),
                "vad_threshold": ("FLOAT", {"default": 0.90, "min": 0.0, "max": 1.0, "step": 0.01}),
                "vad_smooth_ms": ("INT", {"default": 50, "min": 0, "max": 500, "step": 5}),
                "post_gain_db": ("FLOAT", {"default": 0.0, "min": -24.0, "max": 24.0, "step": 0.1}),
                "limit_ceiling": ("BOOLEAN", {"default": True}),
                "ceiling": ("FLOAT", {"default": 0.999, "min": 0.1, "max": 1.0, "step": 0.001}),
            }
        }

    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "execute"
    CATEGORY = CATEGORY

    @classmethod
    def _params(cls):
        if cls._PARAMS is None:
            from ..models.rnnoise.train import load_pretrained
            cls._PARAMS = load_pretrained()
            if cls._PARAMS is None:
                from ..models.rnnoise.model import init_params
                print("[egregora] WARNING: no shipped RNNoise weights "
                      "found — serving RANDOM-INIT denoiser params; "
                      "output will not be denoised", flush=True)
                cls._PARAMS = init_params(0)
        return cls._PARAMS

    def execute(self, audio, frame_ms=20, stereo_mode="per_channel", strength=1.0,
                mix_curve="equal_power", adaptive_mode="more_on_noise",
                adaptive_amount=0.5, vad_threshold=0.90, vad_smooth_ms=50,
                post_gain_db=0.0, limit_ceiling=True, ceiling=0.999):
        from ..models.rnnoise.model import FRAME, denoise

        cn, sr, meta = self._coerced(audio)
        x48 = resample(cn, sr, 48000) if sr != 48000 else cn
        if stereo_mode == "downmix_mono":
            x48 = _downmix_mono(x48, meta)

        t = x48.shape[1]
        xp = torch.nn.functional.pad(x48, (0, (-t) % FRAME))
        segs = max(1, int(os.environ.get("EGREGORA_RNNOISE_SEGMENTS", "1")))
        wet, vads = denoise(self._params(), xp, segments=segs)
        wet = wet[:, :t]

        # the VAD decision on a frame_ms grid: mean-pool over frame_ms / 10
        # engine frames (the last group padded with its edge value)
        group = max(1, int(frame_ms) // 10)
        if group > 1:
            f = vads.shape[1]
            vp = torch.cat([vads, vads[:, -1:].expand(-1, (-f) % group)], 1)
            vp = vp.reshape(vads.shape[0], -1, group).mean(-1)
            vads = torch.repeat_interleave(vp, group, dim=1)[:, :f]

        y48 = torch.stack([
            adaptive_mix(x48[c], wet[c], vads[c], strength=float(strength),
                         mix_curve=str(mix_curve), adaptive_mode=str(adaptive_mode),
                         adaptive_amount=float(adaptive_amount),
                         vad_threshold=float(vad_threshold),
                         vad_smooth_ms=float(vad_smooth_ms), frame_hop=FRAME)
            for c in range(x48.shape[0])])
        y = resample(y48, 48000, sr) if sr != 48000 else y48
        y = post_gain_limit(y, float(post_gain_db), bool(limit_ceiling), float(ceiling))

        meta2 = dict(meta)
        meta2["rnnoise"] = {
            "frame_ms": frame_ms, "stereo_mode": stereo_mode, "strength": strength,
            "mix_curve": mix_curve, "adaptive_mode": adaptive_mode,
            "adaptive_amount": adaptive_amount, "vad_threshold": vad_threshold,
            "vad_smooth_ms": vad_smooth_ms, "post_gain_db": post_gain_db,
            "limit_ceiling": bool(limit_ceiling), "ceiling": ceiling,
        }
        return (comfy_audio(sr, host(y), meta2),)


class Egregora_WPE_Dereverb(DeviceNode):
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio": ("AUDIO",),
                "taps": ("INT", {"default": 10, "min": 3, "max": 32}),
                "delay": ("INT", {"default": 3, "min": 1, "max": 16}),
                "iterations": ("INT", {"default": 3, "min": 1, "max": 10}),
                "n_fft": ("INT", {"default": 1024, "min": 256, "max": 4096, "step": 256}),
                "hop": ("INT", {"default": 256, "min": 64, "max": 1024, "step": 64}),
                "use_float32": ("BOOLEAN", {"default": True}),
            }
        }

    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "execute"
    CATEGORY = CATEGORY

    def execute(self, audio, taps=10, delay=3, iterations=3, n_fft=1024, hop=256,
                use_float32=True):
        from ..models.wpe import wpe_dereverb

        cn, sr, meta = self._coerced(audio)
        try:
            # each batch item is its own mic array of C channels
            b, c = _batch_shape(cn.shape[0], meta)
            items = cn.reshape(b, c, -1)
            z = torch.cat([wpe_dereverb(items[i], taps=int(taps), delay=int(delay),
                                        iterations=int(iterations), n_fft=int(n_fft),
                                        hop=int(hop))
                           for i in range(b)], 0)
        except Exception as e:  # graceful passthrough, as the reference node
            print(f"Warning: WPE processing failed: {e}")
            z = cn
        meta2 = dict(meta)
        meta2["wpe"] = {"taps": taps, "delay": delay, "iterations": iterations,
                        "n_fft": n_fft, "hop": hop}
        return (comfy_audio(sr, host(z), meta2),)


class Egregora_DeepFilterNet_Denoise(DeviceNode):
    _PARAMS = {}  # model_name -> params, the class-level weight cache

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio": ("AUDIO",),
                "dfn_model": (["DeepFilterNet2", "DeepFilterNet3"], {"default": "DeepFilterNet2"}),
                "device": (["auto", "cuda:0", "cpu"], {"default": "auto"}),
                "use_postfilter": ("BOOLEAN", {"default": False, "label_on": "postfilter on", "label_off": "postfilter off"}),
                "limit_ceiling": ("BOOLEAN", {"default": True, "label_on": "limit on", "label_off": "limit off"}),
                "stereo_mode": (["per_channel", "downmix_mono"], {"default": "per_channel"}),
                "frame_ms": ("INT", {"default": 20, "min": 5, "max": 60, "step": 5}),
                "strength": ("FLOAT", {"default": 0.65, "min": 0.0, "max": 1.0, "step": 0.01}),
                "mix_curve": (["equal_power", "linear"], {"default": "equal_power"}),
                "adaptive_vad_source": (["rms", "rnnoise", "none"], {"default": "rms"}),
                "adaptive_mode": (["off", "more_on_noise", "more_on_speech", "gate_on_noise"],
                                  {"default": "more_on_noise"}),
                "adaptive_amount": ("FLOAT", {"default": 0.45, "min": 0.0, "max": 1.0, "step": 0.01}),
                "vad_threshold": ("FLOAT", {"default": 0.90, "min": 0.0, "max": 1.0, "step": 0.01}),
                "vad_smooth_ms": ("INT", {"default": 60, "min": 0, "max": 500, "step": 5}),
                "post_gain_db": ("FLOAT", {"default": 0.5, "min": -24.0, "max": 24.0, "step": 0.1}),
                "ceiling": ("FLOAT", {"default": 0.98, "min": 0.1, "max": 1.0, "step": 0.001}),
            }
        }

    RETURN_TYPES = ("AUDIO",)
    FUNCTION = "execute"
    CATEGORY = CATEGORY

    @classmethod
    def _params(cls, model_name: str):
        if model_name not in cls._PARAMS:
            from ..models.deepfilternet.train import load_pretrained
            params = load_pretrained(model_name)
            if params is None:
                from ..models.deepfilternet.model import DFNConfig, init_params
                print(f"[egregora] WARNING: no shipped DeepFilterNet "
                      f"weights for {model_name!r} — serving RANDOM-INIT "
                      f"params; output will not be denoised", flush=True)
                params = init_params(0, DFNConfig.for_variant(model_name))
            cls._PARAMS[model_name] = params
        return cls._PARAMS[model_name]

    def execute(self, audio, dfn_model="DeepFilterNet2", device="auto",
                use_postfilter=False, limit_ceiling=True, stereo_mode="per_channel",
                frame_ms=20, strength=0.65, mix_curve="equal_power",
                adaptive_vad_source="rms", adaptive_mode="more_on_noise",
                adaptive_amount=0.45, vad_threshold=0.90, vad_smooth_ms=60,
                post_gain_db=0.5, ceiling=0.98):
        from ..models.deepfilternet.model import DFNConfig, enhance

        cn, sr, meta = self._coerced(audio)
        if stereo_mode == "downmix_mono":
            cn = _downmix_mono(cn, meta)
        x48 = resample(cn, sr, 48000) if sr != 48000 else cn

        params = self._params(str(dfn_model))
        wet48 = enhance(params, x48, DFNConfig.for_variant(str(dfn_model)),
                        post_filter=bool(use_postfilter))

        wet = resample(wet48, 48000, sr) if sr != 48000 else wet48
        dry = resample(x48, 48000, sr) if sr != 48000 else x48
        n = min(dry.shape[1], wet.shape[1])
        dry, wet = dry[:, :n], wet[:, :n]

        hop48 = 480
        out = []
        for c in range(dry.shape[0]):
            if adaptive_vad_source == "rnnoise":
                from ..models.rnnoise.model import FRAME, denoise_channel
                t48 = x48.shape[1]
                _, probs = denoise_channel(Egregora_RNNoise_Denoise._params(),
                                           torch.nn.functional.pad(x48[c], (0, (-t48) % FRAME)))
            elif adaptive_vad_source == "rms":
                probs = rms_vad_probs(x48[c], hop48)
            else:
                probs = None
            hop_sr = max(1, int(sr * 0.010))
            out.append(adaptive_mix(dry[c], wet[c], probs, strength=float(strength),
                                    mix_curve=str(mix_curve), adaptive_mode=str(adaptive_mode),
                                    adaptive_amount=float(adaptive_amount),
                                    vad_threshold=float(vad_threshold),
                                    vad_smooth_ms=float(vad_smooth_ms), frame_hop=hop_sr))
        y = post_gain_limit(torch.stack(out), float(post_gain_db), bool(limit_ceiling),
                            float(ceiling))

        meta2 = dict(meta)
        meta2["deepfilternet"] = {
            "model": dfn_model, "device": y.device.type, "use_postfilter": bool(use_postfilter),
            "stereo_mode": stereo_mode, "frame_ms": frame_ms, "strength": strength,
            "mix_curve": mix_curve, "adaptive_vad_source": adaptive_vad_source,
            "adaptive_mode": adaptive_mode, "adaptive_amount": adaptive_amount,
            "vad_threshold": vad_threshold, "vad_smooth_ms": vad_smooth_ms,
            "post_gain_db": post_gain_db, "limit_ceiling": bool(limit_ceiling),
            "ceiling": ceiling,
        }
        return (comfy_audio(sr, host(y), meta2),)


class Egregora_DAC_Encode(DeviceNode):
    _MODELS = {}

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio": ("AUDIO",),
                "model_type": (["44khz", "24khz", "16khz"], {"default": "44khz"}),
                "device": (["auto", "cpu", "cuda"], {"default": "auto"}),
            }
        }

    RETURN_TYPES = ("DICT", "STRING")
    RETURN_NAMES = ("codes", "log")
    FUNCTION = "execute"
    CATEGORY = "Egregora/Codecs"

    @classmethod
    def _model(cls, model_type: str):
        """(model, sample rate) of ``build_dac``, cached on this class."""
        if model_type not in cls._MODELS:
            from ..models.dac.model import build_dac
            cls._MODELS[model_type] = build_dac(model_type)
        return cls._MODELS[model_type]

    def execute(self, audio, model_type="44khz", device="auto"):
        with span("egr.node.dac_encode"):
            cn, sr, meta = self._coerced(audio)
            model, model_sr = self._model(str(model_type))
            model.to(self.DEVICE)
            x = resample(cn, sr, model_sr) if sr != model_sr else cn
            z, codes = model.encode(x)
            latents, codes_h = host(z), host(codes.int())
            count("latent_bytes_out", latents.nbytes + codes_h.nbytes)
            codes_dict = {
                "model_type": str(model_type),
                "sample_rate": int(sr),
                "model_sample_rate": int(model_sr),
                "latents": [[latents]],
                "codes": codes_h,
            }
            log = (f"DAC encode ok: model={model_type}, B=1, C={cn.shape[0]}, "
                   f"sr={sr}->{model_sr}")
            return (codes_dict, log)


class Egregora_DAC_Decode(DeviceNode):
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "codes": ("DICT",),
                "device": (["auto", "cpu", "cuda"], {"default": "auto"}),
            }
        }

    RETURN_TYPES = ("AUDIO", "STRING")
    RETURN_NAMES = ("audio", "log")
    FUNCTION = "execute"
    CATEGORY = "Egregora/Codecs"

    def execute(self, codes, device="auto"):
        model_type = codes.get("model_type", "44khz")
        sr = int(codes.get("sample_rate", 48000))
        model_sr = int(codes.get("model_sample_rate", sr))
        latents_b = codes.get("latents", [])
        if not latents_b:
            raise ValueError("codes.latents empty")
        with span("egr.node.dac_decode"):
            model, _ = Egregora_DAC_Encode._model(str(model_type))
            model.to(self.DEVICE)
            zs = [np.asarray(z_list[0], np.float32) for z_list in latents_b]
            count("latent_bytes_in", sum(z.nbytes for z in zs))
            y = torch.cat([model.decode(torch.as_tensor(z)) for z in zs], 0)
            if model_sr != sr:
                y = resample(y, model_sr, sr)
            log = (f"DAC decode ok: model={model_type}, B={len(latents_b)}, "
                   f"C={y.shape[0]}, {model_sr}->{sr}")
            return (comfy_audio(sr, host(y)), log)


NODE_CLASS_MAPPINGS = {
    "Egregora_RNNoise_Denoise": Egregora_RNNoise_Denoise,
    "Egregora_WPE_Dereverb": Egregora_WPE_Dereverb,
    "Egregora_DeepFilterNet_Denoise": Egregora_DeepFilterNet_Denoise,
    "Egregora_DAC_Encode": Egregora_DAC_Encode,
    "Egregora_DAC_Decode": Egregora_DAC_Decode,
}
NODE_DISPLAY_NAME_MAPPINGS = {
    "Egregora_RNNoise_Denoise": "Egregora RNNoise Denoise",
    "Egregora_WPE_Dereverb": "Egregora WPE Dereverb",
    "Egregora_DeepFilterNet_Denoise": "Egregora DeepFilterNet Denoise",
    "Egregora_DAC_Encode": "Egregora DAC Encode",
    "Egregora_DAC_Decode": "Egregora DAC Decode",
}
