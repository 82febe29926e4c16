"""Device validation for the port's entry points.

Counterpart of ``egregora_tpu/utils/device.py``: one helper with the same
fail-loud, tell-the-user-what-to-do policy.  Every entry point (the CLI,
the workflow executor, the nodes) runs on the card unless the caller asks
for the CPU; asked for the card where there is none, it raises here and
does not carry on on the CPU.
"""
from __future__ import annotations

from typing import List

import torch


def available_platforms() -> List[str]:
    """``["cpu"]``, plus ``"cuda"`` where ``torch.cuda.is_available()``."""
    return ["cpu", "cuda"] if torch.cuda.is_available() else ["cpu"]


def ensure_accelerator(kind: str = "cuda") -> torch.device:
    """``torch.device("cuda:0")`` for ``kind="cuda"``, ``torch.device("cpu")``
    for ``kind="cpu"``; raises ``RuntimeError`` with what was found and the
    CPU route where there is no card."""
    kind = str(kind).lower()
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"unknown device kind {kind!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        plats = ", ".join(available_platforms())
        build = (f"torch {torch.__version__} built without CUDA" if torch.version.cuda is None
                 else f"torch {torch.__version__} (CUDA {torch.version.cuda}) sees no device")
        raise RuntimeError(
            f"No CUDA device detected (available platforms: {plats}; {build}). "
            "The port runs on an NVIDIA card by default; for the CPU pass "
            "--device cpu to the CLI or the workflow runner, device=\"cpu\" to "
            "WorkflowExecutor, or set a node class's DEVICE = \"cpu\".")
    return torch.device("cuda:0")
