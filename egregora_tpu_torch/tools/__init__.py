"""Lab tools that time the port's kernels on the card (``python -m
egregora_tpu_torch.tools.<name>``)."""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import sys
from pathlib import Path


def load_checkout(root, *modules: str) -> tuple:
    """The ``ops`` modules named of the checkout at ``root``: its package
    imported under another name beside this one, so that two designs run
    in one process; each builds its kernels under its own ``_build/``."""
    pkg = Path(root).resolve() / "egregora_tpu_torch"
    name = "egregora_tpu_torch_" + hashlib.sha1(str(pkg).encode()).hexdigest()[:8]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.ops.{m}") for m in modules)


def cuda_ms(fn, rounds: int) -> float:
    """Mean device time of ``fn()`` over ``rounds`` launches, after one,
    from CUDA events."""
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def graph_ms(fn, rounds: int) -> float:
    """Device time of ``fn()`` without the host's launch path: a CUDA graph
    of ``rounds`` calls (captured after two on a side stream), replayed
    once after a warm replay, timed with CUDA events, over ``rounds``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds
