"""egregora_tpu_torch: the PyTorch/CUDA port of ``egregora_tpu``.

Imports torch and numpy, never JAX, flax or ``egregora_tpu``.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; each hand-written kernel (``csrc/``) has a plain PyTorch
version that runs for CPU tensors.  Ported so far: the FlashSR node with
the shipped weights and its pipeline (``models.flashsr.pipeline``), the
eval pack and the null-test suite (``eval/``, ``nodes.eval_pack``,
``nodes.null_suite``), the Fat Llama spectral-enhance nodes
(``ops.spectral``, ``nodes.spectral_enhance``), and the RNNoise, WPE,
DeepFilterNet and DAC nodes (``models.rnnoise``, ``models.wpe``,
``models.deepfilternet``, ``models.dac``, ``nodes.enhance_extras``): all
19 of the JAX package's nodes.

The node registry: ``NODE_CLASS_MAPPINGS`` / ``NODE_DISPLAY_NAME_MAPPINGS``
merge every ported node module's maps; a module that fails to import
leaves only its own keys out, and says why.
"""
from __future__ import annotations

import importlib

NODE_CLASS_MAPPINGS: dict = {}
NODE_DISPLAY_NAME_MAPPINGS: dict = {}

NODE_MODULES = ("super_resolution", "eval_pack", "null_suite", "spectral_enhance",
                "enhance_extras")


def _merge(module_name: str) -> None:
    try:
        mod = importlib.import_module(f".nodes.{module_name}", __name__)
        NODE_CLASS_MAPPINGS.update(mod.NODE_CLASS_MAPPINGS)
        NODE_DISPLAY_NAME_MAPPINGS.update(mod.NODE_DISPLAY_NAME_MAPPINGS)
    except Exception as e:  # one broken module must not take the pack down
        print(f"[egregora_tpu_torch] node module {module_name!r} unavailable: {e}")


for _m in NODE_MODULES:
    _merge(_m)

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
