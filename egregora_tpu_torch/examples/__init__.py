"""The repository's examples, ported: ``full_chain`` (``python -m
egregora_tpu_torch.examples.full_chain in.wav out_96k.wav``)."""
