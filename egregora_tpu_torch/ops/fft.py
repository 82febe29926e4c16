"""Transform-length factorisations of the Fat Llama IST loop.

Counterpart of ``egregora_tpu/ops/fft.py``, only what the port needs.
The JAX package computes long FFTs as two dense DFT matmuls on the MXU
(``fft_mm``, ``rfft_permuted``, ``irfft_permuted``, ``rfft_mm``,
``irfft_mm``): its substitute for the TPU's slow native FFT.  The port
computes the same transforms with ``torch.fft`` (cuFFT on the card,
pocketfft on the CPU), which takes any length, so none of those are
ported.  What stays are the two pure-Python factorisations: they decide
the IST loop's transform length (``balanced_factors``: transform
``n_up`` itself or pad to a power of two) and its loop form
(``alias_factors``: the fold-domain loop or one transform pair an
iteration), and so what function the loop computes.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple


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
