"""The reference's arithmetic: float32 with TF32 off, or the control.

Every product of the sub-models (convolutions, dense layers, attention)
passes its operands through ``operand``.  In the default ``fp32`` mode
that is the identity.  Under ``precision("fp8")`` each operand is
rounded to float8 e4m3 with one scale per tensor (its largest magnitude
maps to 448, e4m3's largest finite value) and the product is then taken
in float32: the arithmetic of an fp8 path with float32 accumulation,
the step below the bfloat16 the configurations state for the models.
The control of the output comparison, which has to come out as not
correct, takes that step for the models and runs the pipeline's float32
signal processing in TF32 (``float32_mode(tf32=True)``), the step below
the float32 (TF32 off) that the port computes it in.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

E4M3_MAX = 448.0

_MODE: contextvars.ContextVar[str] = contextvars.ContextVar("perfbench_precision",
                                                            default="fp32")


def mode() -> str:
    return _MODE.get()


@contextlib.contextmanager
def precision(name: str) -> Iterator[None]:
    """Run the block in ``name`` ("fp32" or "fp8")."""
    if name not in ("fp32", "fp8"):
        raise ValueError(f"precision: expected fp32 or fp8, got {name!r}")
    token = _MODE.set(name)
    try:
        yield
    finally:
        _MODE.reset(token)


@contextlib.contextmanager
def float32_mode(tf32: bool = False) -> Iterator[None]:
    """float32 matmuls and convolutions on the card in full float32 (TF32
    off), or with ``tf32`` in TF32, the control's step below float32;
    the flags are restored on exit."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = prev


def round_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, returned
    in float32."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def operand(x: torch.Tensor) -> torch.Tensor:
    """One operand of a product in the current mode, as float32."""
    return round_e4m3(x) if _MODE.get() == "fp8" else x.float()
