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
