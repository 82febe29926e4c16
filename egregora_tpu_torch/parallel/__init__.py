"""Chunk parallelism over several cards and processes (``torch.distributed``)."""
