"""GCC-PHAT alignment and fractional delay.

Counterpart of ``egregora_tpu/eval/align.py`` (the reference null
suite's ``_xcorr_delay`` / ``_apply_frac_delay_CN``), with its quirks:

* the correlation is rearranged as ``concat(cc[-(n//2-1):], cc[:n//2+1])``,
  which puts lag L at index ``L + n//2 - 1`` while the centre is read at
  ``n//2``: delays come out one sample low unless ``bias_fix`` adds 1;
* the fractional FIR always applies a positive sub-sample delay
  (``frac = |d| - floor(|d|)``, never negated).

Signals are ``[..., N]`` (``apply_frac_delay``: ``[..., C, N]`` with one
delay per leading index), so a batch of pairs runs at once.  The FIR
runs in full float32 on the card (``ops.fir.exact_f32``): a TF32
convolution would cap the null depth near -60 dB.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.fir import exact_f32
from ..ops.stft import device_tensor, hann_symmetric


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` with ``idx`` of the batch's shape, clamped in range."""
    idx = torch.clamp(idx, 0, x.shape[-1] - 1)
    return x.gather(-1, idx[..., None])[..., 0]


def _gcc_phat(a: torch.Tensor, b: torch.Tensor, max_shift: int,
              bias_fix: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(refined delay, correlation surface ``[..., 2*max_shift+1]``)."""
    n = _next_pow2(a.shape[-1] + b.shape[-1])
    r = torch.fft.rfft(b.float(), n=n) * torch.conj(torch.fft.rfft(a.float(), n=n))
    cc = torch.fft.irfft(r / (r.abs() + 1e-12), n=n)
    cc = torch.cat([cc[..., -(n // 2 - 1):], cc[..., : n // 2 + 1]], dim=-1)
    length = cc.shape[-1]
    center = length // 2
    lo = center - int(max_shift)
    size = 2 * int(max_shift) + 1
    if size > length:
        raise ValueError(f"xcorr: max_shift {max_shift} needs {size} lags, the "
                         f"correlation has {length}")
    start = min(max(lo, 0), length - size)     # a window that fits, as a dynamic slice
    w = cc[..., start: start + size]
    idx = lo + torch.argmax(w, dim=-1)
    y0, y1, y2 = _take(cc, idx - 1), _take(cc, idx), _take(cc, idx + 1)
    denom = 2.0 * (y0 - 2.0 * y1 + y2)
    small = denom.abs() < 1e-12
    ok = (idx >= 1) & (idx < length - 1) & ~small
    frac = torch.where(ok, (y0 - y2) / torch.where(small, torch.ones_like(denom), denom),
                       torch.zeros_like(denom))
    d = (idx - center).float() + frac.float()
    return (d + 1.0 if bias_fix else d), w


def xcorr_delay(a: torch.Tensor, b: torch.Tensor, max_shift: int,
                bias_fix: bool = False) -> torch.Tensor:
    """GCC-PHAT delay with parabolic refinement; > 0 means b lags a."""
    return _gcc_phat(a, b, max_shift, bias_fix)[0]


def xcorr_delay_curve(a: torch.Tensor, b: torch.Tensor, max_shift: int,
                      bias_fix: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delay, GCC-PHAT surface over lags [-max_shift, +max_shift])."""
    return _gcc_phat(a, b, max_shift, bias_fix)


def peak_correlation(a: torch.Tensor, b: torch.Tensor,
                     lag: Union[torch.Tensor, float]) -> torch.Tensor:
    """Pearson correlation of ``a`` with ``b`` advanced by ``round(lag)``
    over their overlap."""
    n = a.shape[-1]
    lag = torch.as_tensor(lag, dtype=torch.float32, device=a.device)
    src = torch.arange(n, device=a.device) + torch.round(lag).long()[..., None]
    valid = (src >= 0) & (src < n)
    b_al = b.gather(-1, torch.clamp(src, 0, n - 1).expand(b.shape)) * valid
    a_m = a * valid
    num = (a_m * b_al).sum(-1)
    return num / torch.sqrt((a_m * a_m).sum(-1) * (b_al * b_al).sum(-1) + 1e-20)


def apply_frac_delay(x_cn: torch.Tensor, delay_samples: Union[torch.Tensor, float],
                     taps: int = 64) -> torch.Tensor:
    """Shift ``[..., C, N]`` right by ``delay_samples`` (one per leading
    index), zero-filled: an integer shift, then a Hann-windowed sinc FIR
    of ``max(16, taps)`` taps for the fractional part, convolved 'same'
    as ``np.convolve`` does."""
    x = x_cn.float()
    lead, (c, n) = x.shape[:-2], x.shape[-2:]
    d = torch.as_tensor(delay_samples, dtype=torch.float32, device=x.device)
    mag = d.abs()
    int_d = torch.floor(mag).long()
    frac = mag - int_d.float()
    sign = torch.where(d >= 0, 1, -1)
    src = torch.arange(n, device=x.device) - (sign * int_d)[..., None]     # [..., N]
    valid = ((src >= 0) & (src < n))[..., None, :]
    idx = torch.clamp(src, 0, n - 1)[..., None, :].expand(x.shape)
    y = x.gather(-1, idx) * valid

    m = max(16, int(taps))
    mid = (m - 1) / 2.0
    t = torch.arange(m, dtype=torch.float32, device=x.device)
    h = torch.sinc(t - mid - frac[..., None]) * device_tensor(hann_symmetric, m,
                                                              device=str(x.device))
    h = h / h.sum(-1, keepdim=True)
    pad_l = (m - 1) // 2
    rows = y.reshape(1, -1, n)
    kern = h.flip(-1).reshape(-1, 1, 1, m).expand(-1, c, 1, m).reshape(-1, 1, m)
    with exact_f32():
        conv = F.conv1d(F.pad(rows, (m - 1 - pad_l, pad_l)), kern, groups=rows.shape[1])
    conv = conv.reshape(x.shape)
    shifted = torch.where((frac > 1e-6)[..., None, None], conv, y)
    return torch.where((d.abs() < 1e-6)[..., None, None], x, shifted)


def pad_or_crop(x_cn: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad or crop the last axis to ``n`` samples."""
    m = x_cn.shape[-1]
    if m >= n:
        return x_cn[..., :n]
    return F.pad(x_cn, (0, n - m))
