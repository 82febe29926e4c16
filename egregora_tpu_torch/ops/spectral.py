"""Iterative spectral enhancement ("Fat Llama"): the IST loop on ``torch.fft``.

Counterpart of ``egregora_tpu/ops/spectral.py``.  The input at rate
``sr`` is a subsampled measurement of a signal at ``sr * factor``
(``factor = round(target_bitrate_kbps / source_bitrate_kbps)``, 16-bit
PCM).  From a polyphase-interpolated start the loop alternates

* data consistency: the samples at ``k * factor`` are set to the
  observations (``_clamp_observed``);
* a magnitude gate: spectral bins with ``|X|^2 < thr^2 max |X|^2`` are
  zeroed, the others kept as they are,

then ends with one more clamp and crops the padding.  ``spectral_enhance``
adds the RMS autoscale and the peak normalisation.

The transform length is chosen as the JAX package chooses it:
``n_up = S * factor`` itself where ``ops.fft.balanced_factors`` splits it
into two radices <= 4096, else the next power of two (the padded tail is
free and gets gated, so another length is another function).
``use_matmul_fft`` keeps its meaning for which loop runs:

* ``True`` (the JAX package's accelerator path, the GPU node): where
  ``ops.fft.alias_factors(n_up, factor)`` exists, the fold-domain loop.
  With ``Z = fft(z)`` of length N, ``Y = fft(y_obs)`` of length N/f and
  ``Zr = Z.reshape(C, f, N/f)``, the clamp is ``Zr + (Y - Zr.mean(1))``:
  subsampling aliases the f blocks of the spectrum onto one, zero-stuffing
  repeats it.  So the loop runs on the spectrum with no transform per
  iteration, gates the full spectrum and ends with one ``ifft``.  Else
  the per-iteration loop;
* ``False`` (the JAX CPU node): the per-iteration ``rfft``/``irfft`` loop.

The JAX package runs its accelerator loops on matmul DFTs in a permuted
bin order; gating does not depend on bin order, so both loops here run
``torch.fft`` in natural order (cuFFT on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from .fft import alias_factors, balanced_factors
from .resample import resample_poly


def source_bitrate_kbps(sr: int, channels: int, bit_depth: int = 16) -> float:
    return sr * bit_depth * channels / 1000.0


def upscale_factor(sr: int, channels: int, target_bitrate_kbps: int,
                   bit_depth: int = 16) -> int:
    """Integer rate multiplier implied by the target bitrate (>= 1)."""
    src = source_bitrate_kbps(sr, channels, bit_depth)
    return max(1, int(round(target_bitrate_kbps / src)))


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def transform_length(n_up: int) -> int:
    """The IST loop's transform length for ``n_up`` output samples."""
    return n_up if balanced_factors(n_up) else _next_pow2(n_up)


def fold_loop(n_up: int, factor: int, use_matmul_fft: bool) -> bool:
    """Whether ``ist_upscale`` runs the fold-domain loop."""
    return (use_matmul_fft and factor > 1 and transform_length(n_up) == n_up
            and alias_factors(n_up, factor) is not None)


def _clamp_observed(x: torch.Tensor, y_obs: torch.Tensor, factor: int) -> torch.Tensor:
    """``x[:, k * factor] = y_obs[:, k]``, in place."""
    x[:, : y_obs.shape[1] * factor: factor] = y_obs
    return x


def _gate(spec: torch.Tensor, thr2: float) -> torch.Tensor:
    """Zero the bins with ``|X|^2 < thr2 * max |X|^2`` (per channel)."""
    mag2 = torch.view_as_real(spec).square().sum(-1)
    tau2 = thr2 * mag2.reshape(mag2.shape[0], -1).amax(-1)
    keep = mag2 >= tau2.reshape((-1,) + (1,) * (mag2.ndim - 1))
    return torch.where(keep, spec, torch.zeros((), dtype=spec.dtype, device=spec.device))


def ist_upscale(x_cs: torch.Tensor, factor: int, max_iterations: int,
                threshold_value: float, use_matmul_fft: bool = False) -> torch.Tensor:
    """IST spectral recovery of ``[C, S]`` onto a ``factor``-times grid:
    ``[C, S * factor]`` float32 on ``x_cs``'s device."""
    c, s = x_cs.shape
    n_up = s * factor
    n_fft = transform_length(n_up)
    y_obs = x_cs.float()
    interp = resample_poly(y_obs, 1, factor) if factor > 1 else y_obs
    x0 = torch.zeros(c, n_fft, dtype=torch.float32, device=y_obs.device)
    x0[:, :n_up] = interp[:, :n_up]
    thr = np.float32(threshold_value)
    thr2 = float(np.float32(thr * thr))

    if fold_loop(n_up, factor, use_matmul_fft):
        z = torch.fft.fft(x0).reshape(c, factor, n_up // factor)
        y = torch.fft.fft(y_obs)[:, None, :]
        for _ in range(int(max_iterations)):
            z = _gate(z + (y - z.mean(1, keepdim=True)), thr2)
        x = torch.fft.ifft(z.reshape(c, n_up)).real.contiguous()
        return _clamp_observed(x, y_obs, factor)[:, :n_up]

    x = x0
    for _ in range(int(max_iterations)):
        spec = _gate(torch.fft.rfft(_clamp_observed(x, y_obs, factor)), thr2)
        x = torch.fft.irfft(spec, n=n_fft)
    return _clamp_observed(x, y_obs, factor)[:, :n_up]


def spectral_enhance(x_cs: torch.Tensor, factor: int, max_iterations: int,
                     threshold_value: float, toggle_normalize: bool = True,
                     toggle_autoscale: bool = True, peak_ceiling: float = 0.99,
                     use_matmul_fft: bool = False) -> torch.Tensor:
    """Full enhance pass: ``ist_upscale`` + RMS autoscale + peak
    normalisation; ``[C, S] -> [C, S * factor]`` at ``sr * factor``."""
    x = x_cs.float()
    in_rms = torch.sqrt(x.square().mean() + 1e-20)
    y = ist_upscale(x, factor, max_iterations, threshold_value,
                    use_matmul_fft=use_matmul_fft)
    if toggle_autoscale:
        out_rms = torch.sqrt(y.square().mean() + 1e-20)
        y = y * (in_rms / out_rms)
    if toggle_normalize:
        peak = y.abs().max()
        ceiling = float(np.float32(peak_ceiling))
        y = y * torch.where(peak > ceiling, ceiling / (peak + 1e-20), torch.ones_like(peak))
    return y
