"""Chunk parallelism over the cards of one process.

Counterpart of ``egregora_tpu/parallel/mesh.py``.  FlashSR's 5.12 s
chunks are independent, so the chunk batch is this domain's sequence
axis: the JAX package shards it over a 1-D device mesh (axis ``"chunk"``)
with the weights replicated.  Here a ``ChunkMesh`` is the list of cards
a process drives plus the number of processes (``world``) that share the
axis through ``torch.distributed`` (``parallel.multihost``): each card
runs its equal slice of the leading axis on its own stream with its own
copy of the weights, and the slices are gathered in order on the first
card.  No collective runs until that gather.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device`` with a CUDA index filled in (the
    current card for a bare ``"cuda"``), so that two names of one card
    compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class ChunkMesh:
    """The cards of this process (``devices``) and the processes that
    share the chunk axis (``world``); ``size`` counts every card of the
    axis, as a JAX mesh's ``size`` does."""

    devices: Tuple[torch.device, ...]
    world: int = 1
    axis_names: Tuple[str, ...] = ("chunk",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("ChunkMesh: no devices")
        object.__setattr__(self, "devices", tuple(resolve(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices) * self.world


def make_chunk_mesh(devices: Optional[Sequence] = None) -> ChunkMesh:
    """A one-process mesh over ``devices``, by default every visible card;
    raises without one (the mesh never falls back to the CPU)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_chunk_mesh: no CUDA device is visible; pass the "
                               "devices to build a mesh of others")
        devices = [torch.device("cuda", i) for i in range(n)]
    return ChunkMesh(tuple(devices))


def shard_chunks(mesh: ChunkMesh, chunks: torch.Tensor) -> list:
    """``[K, ...]`` as ``len(mesh.devices)`` equal slices of the leading
    axis, each on its card (K a multiple of the local device count)."""
    n = len(mesh.devices)
    if chunks.shape[0] % n:
        raise ValueError(f"shard_chunks: {chunks.shape[0]} chunks do not split over "
                         f"{n} devices (pad to a multiple: ops.wola.chunk_batch)")
    return [part.to(dev, non_blocking=True)
            for part, dev in zip(chunks.chunk(n), mesh.devices)]


def replicate(mesh: ChunkMesh, obj) -> list:
    """One copy of ``obj`` (a module, or anything with ``parameters()``
    and an in-place ``to(device)``, e.g. ``FlashSRModules``) a card of the
    mesh: ``obj`` itself on the card it lives on, a deep copy on each
    other.  The copies are cached on ``obj`` by device and are snapshots:
    weights changed later are not copied again."""
    cache = obj.__dict__.pop("_mesh_replicas", {})
    try:
        home = next(iter(obj.parameters())).device
        out = []
        for dev in mesh.devices:
            if dev == home:
                out.append(obj)
                continue
            if dev not in cache:
                cache[dev] = copy.deepcopy(obj).to(dev)
            out.append(cache[dev])
        return out
    finally:
        obj.__dict__["_mesh_replicas"] = cache


def chunk_parallel(fn: Callable, mesh: ChunkMesh) -> Callable:
    """``fn(i, chunks_i) -> out_i`` run for each card ``i`` of the mesh on
    its equal slice of the leading axis, on a stream of its own; returns
    ``run(chunks[K, ...]) -> [K, ...]`` with the slices concatenated in
    order on the first card.  K must be a multiple of the local device
    count."""

    @functools.wraps(fn)
    def run(chunks: torch.Tensor) -> torch.Tensor:
        first = mesh.devices[0]
        n = len(mesh.devices)
        if chunks.shape[0] % n:
            raise ValueError(f"chunk_parallel: {chunks.shape[0]} chunks do not split "
                             f"over {n} devices")
        if n == 1:
            return fn(0, chunks.to(first))
        outs, streams = [], []
        for i, (dev, part) in enumerate(zip(mesh.devices, chunks.chunk(n))):
            if dev.type != "cuda":
                outs.append(fn(i, part.to(dev)))
                continue
            src = torch.cuda.current_stream(chunks.device) if chunks.is_cuda else None
            stream = torch.cuda.Stream(device=dev)
            if src is not None:
                stream.wait_stream(src)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                part = part.to(dev, non_blocking=True)
                out = fn(i, part)
            streams.append(stream)
            outs.append(out)
        if first.type == "cuda":
            main = torch.cuda.current_stream(first)
            for stream in streams:
                main.wait_stream(stream)
            for out in outs:
                if out.is_cuda:
                    out.record_stream(main)
        return torch.cat([o.to(first) for o in outs])

    return run
