"""Transform-length factorisations of the Fat Llama IST loop, and the JAX
package's matmul-DFT entry points over ``torch.fft``.

Counterpart of ``egregora_tpu/ops/fft.py``.  The JAX package computes
long FFTs as two dense DFT matmuls on the MXU: its substitute for the
TPU's slow native FFT.  The port computes the same transforms with
``torch.fft`` (cuFFT on the card, pocketfft on the CPU), which takes any
length.  ``fft_mm``, ``rfft_mm``, ``irfft_mm``, ``rfft_permuted``,
``irfft_permuted`` and ``permuted_fft_bases`` keep the JAX signatures,
the split (re, im) operands and the bins' order (the permuted pair's
block layout too) over one ``torch.fft`` call each; nothing of the port
calls them.  The two pure-Python factorisations decide the IST loop's
transform length (``balanced_factors``: transform ``n_up`` itself or pad
to a power of two) and its loop form (``alias_factors``: the fold-domain
loop or one transform pair an iteration), and so what function the loop
computes.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch


@functools.lru_cache(maxsize=64)
def balanced_factors(n: int, max_factor: int = 4096) -> Tuple[int, int] | None:
    """``n = n1 * n2`` with both <= max_factor minimizing n1 + n2, or None."""
    best = None
    i = int(math.isqrt(n))
    while i >= 2:
        if n % i == 0:
            j = n // i
            if i <= max_factor and j <= max_factor:
                return (i, j)
            if j > max_factor:
                return best
        i -= 1
    return best


@functools.lru_cache(maxsize=64)
def alias_factors(n: int, f: int, max_factor: int = 4096) -> Tuple[int, int] | None:
    """Balanced ``n = n1 * n2`` with ``f | n2`` (both <= max_factor), or
    None: where it exists, the JAX package's IST loop runs in the fold
    domain (``ops.spectral.ist_upscale``)."""
    if f < 1 or n % f:
        return None
    i = int(math.isqrt(n))
    while i >= 2:
        if n % i == 0:
            j = n // i
            if j > max_factor:
                return None        # j only grows as i shrinks
            if i <= max_factor:
                if j % f == 0:
                    return (i, j)
                if i % f == 0:
                    return (j, i)  # swapped pair puts f on the n2 side
        i -= 1
    return None


def _split_factor(n: int) -> Tuple[int, int]:
    """``n = n1 * n2`` with both as close to sqrt(n) as possible (power-of-2 n)."""
    if n & (n - 1):
        raise ValueError(f"the permuted FFT needs a power-of-2 length or factors, got {n}")
    p = n.bit_length() - 1
    return 1 << (p // 2), 1 << (p - p // 2)


def fft_mm(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex FFT along the last axis as split (re, im); ``inverse``
    computes the unscaled inverse (divide by N for ifft)."""
    z = torch.complex(xr, xi)
    y = torch.fft.ifft(z, norm="forward") if inverse else torch.fft.fft(z)
    return y.real, y.imag


def rfft_mm(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real-input FFT -> (re, im) of ``[..., N // 2 + 1]``."""
    y = torch.fft.rfft(x)
    return y.real, y.imag


def irfft_mm(xr: torch.Tensor, xi: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``rfft_mm`` -> real ``[..., n]``."""
    return torch.fft.irfft(torch.complex(xr, xi), n=n)


def permuted_fft_bases(n: int, factors: Tuple[int, int] | None = None) -> dict:
    """The permuted pair's factors, ``{"factors": (n1, n2)}``, chosen as
    the JAX package chooses them (its DFT and twiddle matrices are
    ``torch.fft``'s business here)."""
    return {"factors": tuple(factors or balanced_factors(n) or _split_factor(n))}


def rfft_permuted(x: torch.Tensor, factors: Tuple[int, int] | None = None,
                  bases: dict | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int]]:
    """Full complex FFT of a real ``[..., n]`` in the JAX package's block
    layout: ``[..., k1, k2]`` holds bin ``k1 + n1 * k2``; with the factor
    pair.  Use with ``irfft_permuted``."""
    n = x.shape[-1]
    n1, n2 = (bases or permuted_fft_bases(n, factors))["factors"]
    if n1 * n2 != n:
        raise ValueError(f"factors {(n1, n2)} do not multiply to {n}")
    y = torch.fft.fft(x).reshape(x.shape[:-1] + (n2, n1)).transpose(-1, -2)
    return y.real, y.imag, (n1, n2)


def irfft_permuted(yr: torch.Tensor, yi: torch.Tensor, n: int,
                   factors: Tuple[int, int] | None = None,
                   bases: dict | None = None) -> torch.Tensor:
    """Inverse of ``rfft_permuted`` -> the real part of the inverse
    transform, ``[..., n]``."""
    n1, n2 = (bases or permuted_fft_bases(n, factors))["factors"]
    if n1 * n2 != n:
        raise ValueError(f"factors {(n1, n2)} do not multiply to {n}")
    y = torch.complex(yr, yi).transpose(-1, -2).reshape(yr.shape[:-2] + (n,))
    return torch.fft.ifft(y).real
