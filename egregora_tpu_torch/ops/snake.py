"""The DAC's Snake activation and the wrapper of its hand-written kernel
``csrc/snake.cu``.

``x + sin^2(alpha x) / (alpha + 1e-9)`` over ``[B, C, T]``, alpha ``[C]``
float32, clamped from below at ``floor`` where that is positive.  The
JAX package's Snake is plain ``jnp``, so the kernel replaces no Pallas
kernel: it is the port's own, for the DAC path, where the plain version's
float32 passes held the largest share of the card's time.

``snake(x, alpha, floor, out_dtype)``: a CUDA tensor goes to the kernel
(one pass: the input read once, float32 in registers, the output written
once in ``out_dtype``, the dtype of the conv it feeds) or raises on what
the kernel does not take; a CPU tensor goes to the plain version,
``snake_plain(...).to(out_dtype)``.  The kernel takes ``x`` contiguous
(NCW) or channels-last (NWC: ``x.transpose(1, 2)`` contiguous, what the
DAC's convs read and write), chosen from its strides, and returns the
output in the same layout; the plain version keeps the input's layout
as PyTorch's elementwise ops do.  On the card with grad enabled and
``x`` or ``alpha`` requiring it, the kernel runs inside an autograd
Function whose backward recomputes the plain version (``snake_backward``),
so the clamp's zero gradient below the floor is kept.

``launches`` counts the kernel's launches; each also counts
``snake_launches`` in the innermost open span (``utils.profiling``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..utils import cuda_build
from ..utils.profiling import count

KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# launches since the last reset; counted where the kernel launches and
# nowhere else
launches = 0

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("snake")
        lib.snake_forward.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                                      ctypes.c_int, ctypes.c_void_p]
        lib.snake_forward.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def snake_plain(x: torch.Tensor, alpha: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """``x + sin^2(alpha x) / (alpha + 1e-9)`` over ``[B, C, T]`` in float32,
    alpha clamped from below at ``floor`` where it is positive."""
    a = (alpha.clamp_min(floor) if floor > 0.0 else alpha).float()[:, None]
    x = x.float()
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def kernel_layout(x: torch.Tensor) -> bool:
    """Whether the kernel reads ``x [B, C, T]`` as NWC (channels-last: its
    ``[B, T, C]`` transpose contiguous) rather than NCW (contiguous);
    raises on any other layout."""
    if x.is_contiguous():
        return False
    if x.transpose(1, 2).is_contiguous():
        return True
    raise ValueError(f"snake: the input must be contiguous or channels-last (its [B, T, C] "
                     f"transpose contiguous), got strides {x.stride()}")


def _launch(x: torch.Tensor, alpha: torch.Tensor, y: torch.Tensor, floor: float,
            nwc: bool) -> None:
    """One launch of the library on ``x``'s card into ``y``; raises off the
    card."""
    if x.device.type != "cuda":
        raise ValueError(f"snake: the kernel runs on a CUDA tensor, not on {x.device}")
    b, c, t = x.shape
    with cuda_build.on_device(x.device):
        err = _lib().snake_forward(x.data_ptr(), int(x.dtype == torch.bfloat16), alpha.data_ptr(),
                                   y.data_ptr(), int(y.dtype == torch.bfloat16), b * c, c, t,
                                   float(floor), int(nwc),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"snake: launch failed with cudaError_t {err}")


def snake_kernel(x: torch.Tensor, alpha: torch.Tensor, floor: float,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's one pass on the card: ``[B, C, T]`` bf16 or float32
    ``x``, contiguous or channels-last (``kernel_layout``), float32 ``alpha
    [C]`` on the same card; a new tensor in ``out_dtype`` (bf16 or float32)
    with ``x``'s layout."""
    if x.dim() != 3 or x.dtype not in KERNEL_DTYPES or out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"snake: expected bf16 or float32 [B, C, T] into bf16 or float32, "
                         f"got {x.dtype} {tuple(x.shape)} into {out_dtype}")
    nwc = kernel_layout(x)
    b, c, t = x.shape
    if (alpha.device != x.device or alpha.dtype != torch.float32 or alpha.shape != (c,)
            or not alpha.is_contiguous()):
        raise ValueError(f"snake: alpha must be contiguous float32 [{c}] on {x.device}, got "
                         f"{alpha.dtype} {tuple(alpha.shape)} on {alpha.device}")
    y = (torch.empty((b, t, c), dtype=out_dtype, device=x.device).transpose(1, 2) if nwc
         else torch.empty(x.shape, dtype=out_dtype, device=x.device))
    if not y.numel():
        return y
    _launch(x, alpha, y, floor, nwc)
    global launches
    launches += 1
    count("snake_launches")
    return y


def snake_backward(x: torch.Tensor, alpha: torch.Tensor, floor: float, out_dtype: torch.dtype,
                   grad: torch.Tensor, needs: Sequence[bool] = (True, True)
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The gradients of ``snake_plain(x, alpha, floor).to(out_dtype)``
    against ``grad``, for ``x`` and ``alpha`` where ``needs`` says so (else
    None): autograd of the plain version, recomputed."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_(bool(needs[0]))
        al = alpha.detach().requires_grad_(bool(needs[1]))
        wanted = [v for v, n in zip((xs, al), needs) if n]
        y = snake_plain(xs, al, floor).to(out_dtype)
        got = iter(torch.autograd.grad(y, wanted, grad) if wanted else ())
    return tuple(next(got) if n else None for n in needs)


class _SnakeFunction(torch.autograd.Function):
    """The kernel forward; the plain version's gradients backward."""

    @staticmethod
    def forward(ctx, x, alpha, floor, out_dtype):
        ctx.save_for_backward(x, alpha)
        ctx.floor, ctx.out_dtype = floor, out_dtype
        return snake_kernel(x, alpha, floor, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        x, alpha = ctx.saved_tensors
        gx, ga = snake_backward(x, alpha, ctx.floor, ctx.out_dtype, grad, ctx.needs_input_grad[:2])
        return gx, ga, None, None


def snake(x: torch.Tensor, alpha: torch.Tensor, floor: float,
          out_dtype: torch.dtype) -> torch.Tensor:
    """Snake over ``[B, C, T]`` in ``out_dtype``: the kernel on the card,
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return snake_plain(x, alpha, floor).to(out_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        return _SnakeFunction.apply(x, alpha, floor, out_dtype)
    return snake_kernel(x, alpha, floor, out_dtype)
