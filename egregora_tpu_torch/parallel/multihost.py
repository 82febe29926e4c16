"""Chunk parallelism across processes: ``torch.distributed`` set-up.

Counterpart of ``egregora_tpu/parallel/multihost.py``, with its names
and its environment fallbacks (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``).  The JAX package joins the hosts
with ``jax.distributed.initialize`` and builds one global mesh; here
each process joins a ``torch.distributed`` process group and drives the
cards it owns, and a ``ChunkMesh`` records how many processes share the
chunk axis.  Chunk batches split across the processes by
``local_batch_slice``; weights are replicated, so the only traffic is
the gathers of results and, in training, one all-reduce of the gradients
and of the loss's sums a step.

Backend: NCCL when each rank of this host has a card of its own, else
gloo (NCCL refuses two ranks on one card).  gloo carries every
collective the port uses (``all_reduce``, ``all_gather``,
``all_gather_into_tensor``, ``broadcast``) on CUDA tensors directly.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import ChunkMesh


def world() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's index in the group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def pick_backend(num_processes: int) -> str:
    """NCCL when every rank on this host (``LOCAL_WORLD_SIZE``, else
    ``num_processes``) has a card of its own, else gloo."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if n >= local else "gloo"


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Idempotent ``torch.distributed.init_process_group`` with the JAX
    helper's environment fallbacks; a no-op without a coordinator
    (``host:port`` or a URL such as ``tcp://localhost:29500``).  Under
    NCCL each rank takes the card ``process_id % device_count()``."""
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return  # single-process run; nothing to do
    n = int(num_processes if num_processes is not None
            else os.environ.get("NUM_PROCESSES", 1))
    pid = int(process_id if process_id is not None else os.environ.get("PROCESS_ID", 0))
    backend = backend or pick_backend(n)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url, world_size=n, rank=pid)


def make_global_chunk_mesh(devices: Optional[Sequence] = None) -> ChunkMesh:
    """The chunk axis over every process of the group: this process's
    ``devices`` (by default its own card, ``cuda:{rank % device_count}``,
    one card a process as NCCL wants it; raises without a card) times
    the group's size."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_global_chunk_mesh: no CUDA device is visible; "
                               "pass the devices to build a mesh of others")
        devices = [torch.device("cuda", rank() % n)]
    return ChunkMesh(tuple(devices), world=world())


def local_batch_slice(global_batch: int) -> slice:
    """The half-open range of a global chunk batch owned by this process."""
    n_proc = world()
    per = -(-global_batch // n_proc)
    i = rank()
    return slice(i * per, min((i + 1) * per, global_batch))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's equal-sized ``t`` concatenated along the leading
    axis in rank order (``t`` itself with one process)."""
    n = world()
    if n == 1:
        return t
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous())
    return out
