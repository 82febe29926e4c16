"""egregora_tpu_torch: the PyTorch/CUDA port of ``egregora_tpu``.

Imports torch and numpy, never JAX, flax or ``egregora_tpu``.
Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; each hand-written kernel (``csrc/``) has a plain PyTorch
version that runs for CPU tensors.  Ported so far: the FlashSR node
(``nodes.NODE_CLASS_MAPPINGS["EgregoraAudioUpscaler"]``) with the shipped
weights, and its pipeline (``models.flashsr.pipeline.FlashSRPipeline``)
at the full config and at the shipped compact trios.
"""
