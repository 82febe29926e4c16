"""FlashSR super-resolution node: the ``EgregoraAudioUpscaler`` key.

Counterpart of ``egregora_tpu/nodes/super_resolution.py``, with the same
inputs (``audio``, ``lowpass_input`` BOOLEAN, ``output_sr`` in {48000,
44100, 96000}) and one AUDIO output.  The pipeline (weights from
``distill.resolve_flashsr``) is built once per device and cached on the
class.  It runs on ``DeviceNode.DEVICE``, the card unless a caller sets
``"cpu"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.flashsr.pipeline import FlashSRPipeline
from .base import DeviceNode, buffer_to_comfy, to_buffer

FUNCTION = "run"
CATEGORY = "Egregora/Audio"


class EgregoraAudioSuperResolution(DeviceNode):
    _PIPE: Optional[FlashSRPipeline] = None

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "audio": ("AUDIO",),
                "lowpass_input": ("BOOLEAN", {"default": False}),
                "output_sr": (["48000", "44100", "96000"], {"default": "48000"}),
            }
        }

    RETURN_TYPES = ("AUDIO",)
    FUNCTION = FUNCTION
    CATEGORY = CATEGORY
    OUTPUT_NODE = False

    @classmethod
    def _pipeline(cls) -> FlashSRPipeline:
        # one cached pipeline, rebuilt when DEVICE names another device
        if cls._PIPE is None or cls._PIPE.device.type != torch.device(cls.DEVICE).type:
            from ..models.flashsr.distill import resolve_flashsr
            cfg, params, source = resolve_flashsr()
            pipe = FlashSRPipeline(cfg, params=params, device=cls.DEVICE)
            pipe.weight_source = source   # distilled-istft | distilled | random
            cls._PIPE = pipe
        return cls._PIPE

    def run(self, audio=None, lowpass_input=False, output_sr="48000"):
        # samples stay host-side: on the card the pipeline's dispatch edge
        # then moves them as pcm16 (half the bytes each way)
        buf = to_buffer(audio)
        out = self._pipeline().process(buf, lowpass_input=bool(lowpass_input),
                                       output_sr=int(output_sr))
        return (buffer_to_comfy(out),)


NODE_CLASS_MAPPINGS = {"EgregoraAudioUpscaler": EgregoraAudioSuperResolution}
NODE_DISPLAY_NAME_MAPPINGS = {
    "EgregoraAudioUpscaler": "🎧 Audio Super Resolution (FlashSR)",
}
