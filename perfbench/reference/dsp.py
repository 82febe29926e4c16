"""The signal processing of the FlashSR node in plain float32 PyTorch.

A frozen copy of the port's ``ops/{stft,resample,wola}.py``,
``models/flashsr/mel.py`` and of the one-step noise draw of
``models/flashsr/prng.py`` (JAX's threefry2x32 ``normal``, bit for bit),
with only what the node's path uses: the windowed-DFT STFT and its dense
inverse, the Slaney log-mel front end, the envelope projection, the
Kaiser polyphase resampler, chunking and the Hann-weighted overlap-add.  Tables are built in numpy, as the port builds
them, and kept per device.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 48000
N_FFT = 2048
HOP = 480
N_MELS = 256
FMIN, FMAX = 20.0, 24000.0


@functools.lru_cache(maxsize=64)
def _table(fn, args: tuple, device: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(fn(*args))).to(device)


def table(fn, *args, device) -> torch.Tensor:
    """``fn(*args)`` (a numpy table) as a tensor on ``device``, cached."""
    return _table(fn, args, str(device))


# ---- STFT -----------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def hann_symmetric(n: int) -> np.ndarray:
    return np.hanning(n).astype(np.float32)


@functools.lru_cache(maxsize=32)
def hann_periodic(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


def frame_strided(x: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """``[..., T] -> [..., 1 + (T - n)//hop, n]`` (a short signal zero-padded)."""
    if x.shape[-1] < n:
        x = F.pad(x, (0, n - x.shape[-1]))
    return x.unfold(-1, n, hop)


def _dft_phase(rows: int, cols: int, modulus: int) -> np.ndarray:
    r = np.arange(rows, dtype=np.int64)[:, None]
    c = np.arange(cols, dtype=np.int64)[None, :]
    return ((r * c) % modulus).astype(np.float32)


@functools.lru_cache(maxsize=8)
def analysis_basis(n_fft: int) -> np.ndarray:
    """``[n_fft, 2*(n_fft//2+1)]`` periodic-Hann-windowed cos | -sin."""
    nbins = n_fft // 2 + 1
    ang = _dft_phase(n_fft, nbins, n_fft) * np.float32(-2.0 * np.pi / n_fft)
    w = hann_periodic(n_fft)[:, None]
    return np.concatenate([np.cos(ang) * w, np.sin(ang) * w], axis=1)


@functools.lru_cache(maxsize=8)
def synthesis_basis(n_fft: int) -> np.ndarray:
    """``[2*(n_fft//2+1), n_fft]``: ``[re | im] @ basis == irfft * window``."""
    nbins = n_fft // 2 + 1
    ang = _dft_phase(nbins, n_fft, n_fft) * np.float32(2.0 * np.pi / n_fft)
    ck = np.full((nbins, 1), 2.0 / n_fft, np.float32)
    ck[0, 0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        ck[-1, 0] = 1.0 / n_fft
    w = hann_periodic(n_fft)[None, :]
    return np.concatenate([np.cos(ang) * ck * w, -np.sin(ang) * ck * w], axis=0)


def stft_conv(x: torch.Tensor, n_fft: int, hop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., T] -> (re, im)`` each ``[..., frames, n_fft//2+1]``."""
    y = frame_strided(x.float(), n_fft, hop) @ table(analysis_basis, n_fft, device=x.device)
    nbins = n_fft // 2 + 1
    return y[..., :nbins], y[..., nbins:]


@functools.lru_cache(maxsize=64)
def ola_wsum(n_fft: int, hop: int, frames: int) -> np.ndarray:
    w2 = hann_periodic(n_fft).astype(np.float64) ** 2
    ws = np.zeros((frames - 1) * hop + n_fft, np.float64)
    for f in range(frames):
        ws[f * hop: f * hop + n_fft] += w2
    return ws.astype(np.float32)


def istft_dense(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """``[..., F, n_fft//2+1] -> [..., (F-1)*hop + n_fft]``: synthesis
    window, squared-window overlap-add normalisation, samples covered
    below 1e-3 of the peak zeroed."""
    k_full = n_fft // hop
    frames = torch.cat([re, im], dim=-1) @ table(synthesis_basis, n_fft, device=re.device)
    f = frames.shape[-2]
    sub = frames.reshape(frames.shape[:-1] + (k_full, hop))
    acc = frames.new_zeros(frames.shape[:-2] + (f - 1 + k_full, hop))
    for j in range(k_full):
        acc[..., j: j + f, :] += sub[..., :, j, :]
    y = acc.reshape(acc.shape[:-2] + (-1,))
    floor = 1e-3 * float(ola_wsum(n_fft, hop, f).max())
    wsum = table(ola_wsum, n_fft, hop, f, device=re.device)
    keep = wsum >= floor
    return y * keep / torch.where(keep, wsum, torch.ones_like(wsum))


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(
        lead + (x.shape[-1] + 2 * pad,))


# ---- mel front end and envelope projection --------------------------------

def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_mel, logstep = 200.0 / 3, 1000.0 / (200.0 / 3), np.log(6.4) / 27.0
    return np.where(f >= 1000.0, min_log_mel + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_mel, logstep = 200.0 / 3, 1000.0 / (200.0 / 3), np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, 1000.0 * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-scale, area-normalised triangles ``[n_fft//2+1, n_mels]``."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(np.array(FMIN)), _hz_to_mel(np.array(FMAX)),
                                n_mels + 2))
    fb = np.zeros((n_freqs, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz[m], hz[m + 1], hz[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    fb *= (2.0 / (hz[2: n_mels + 2] - hz[:n_mels]))[None, :]
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_band_peaks(n_mels: int) -> np.ndarray:
    mel_pts = np.linspace(_hz_to_mel(np.array(FMIN)), _hz_to_mel(np.array(FMAX)), n_mels + 2)
    return _mel_to_hz(mel_pts)[1: n_mels + 1].astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_unmix(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    fb = mel_filterbank(sr, n_fft, n_mels)
    return (fb / np.maximum(fb.sum(axis=1, keepdims=True), 1e-10)).T.astype(np.float32)


@functools.lru_cache(maxsize=8)
def frame_interp(frames_out: int, hop_out: int, frames_in: int, hop_in: int) -> np.ndarray:
    pos = np.clip(np.arange(frames_out) * (hop_out / hop_in), 0.0, frames_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, frames_in - 1)
    w = (pos - lo).astype(np.float32)
    m = np.zeros((frames_out, frames_in), np.float32)
    m[np.arange(frames_out), lo] += 1.0 - w
    m[np.arange(frames_out), hi] += w
    return m


@functools.lru_cache(maxsize=8)
def log_band_weight(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    return np.log(np.maximum(mel_filterbank(sr, n_fft, n_mels).sum(axis=0), 1e-10),
                  dtype=np.float32)


@functools.lru_cache(maxsize=8)
def covered_bins(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    return mel_filterbank(sr, n_fft, n_mels).sum(axis=1) > 0


def log_mel(x: torch.Tensor) -> torch.Tensor:
    """``[..., T] -> [..., T // 480 + 1, 256]`` natural-log mel."""
    re, im = stft_conv(reflect_pad(x.float(), N_FFT // 2), N_FFT, HOP)
    mel = torch.sqrt(re * re + im * im + 1e-20) @ table(
        mel_filterbank, SAMPLE_RATE, N_FFT, N_MELS, device=x.device)
    return torch.log(torch.clamp(mel, min=1e-5))


def envelope_gain(re: torch.Tensor, im: torch.Tensor, log_mel_tgt: torch.Tensor, n_fft: int,
                  hop: int, replace: bool, max_log_gain: float = 2.5) -> torch.Tensor:
    """Per-bin gain projecting an STFT onto a predicted log-mel envelope
    (``replace``: the gain that makes the magnitude the envelope itself)."""
    sr = SAMPLE_RATE
    mel_frames, n_mels = log_mel_tgt.shape[-2:]
    dev = re.device
    mag = torch.sqrt(re * re + im * im + 1e-20)
    ti = table(frame_interp, re.shape[-2], hop, mel_frames, HOP, device=dev)
    tgt = torch.einsum("fj,...jm->...fm", ti, log_mel_tgt.float())
    unmix = table(mel_unmix, sr, n_fft, n_mels, device=dev)
    if replace:
        env_log = (tgt - table(log_band_weight, sr, n_fft, n_mels, device=dev)) @ unmix
        dlog = torch.clamp(env_log - torch.log(torch.clamp(mag, min=1e-5)),
                           -max_log_gain, max_log_gain)
        covered = table(covered_bins, sr, n_fft, n_mels, device=dev)
        return torch.where(covered, torch.exp(dlog), torch.ones_like(dlog))
    cur = torch.log(torch.clamp(mag @ table(mel_filterbank, sr, n_fft, n_mels, device=dev),
                                min=1e-5))
    return torch.exp(torch.clamp(tgt - cur, -max_log_gain, max_log_gain) @ unmix)


def bandwidth_mask(rl: torch.Tensor, il: torch.Tensor, log_mel_pred: torch.Tensor,
                   max_hz: float, n_fft: int, delta: float = 2.0,
                   margin: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Low-band weight ``[..., 1, bins]``: a sigmoid step at the peak of
    the highest mel band whose observed level reaches the predicted level
    (within ``delta`` nats), at most ``max_hz``; ``max_hz`` where no band
    does.  Also the lowest and the highest merge edge (Hz, ``[..., 2]``,
    at most ``max_hz``) that a prediction within ``margin`` nats of this
    one can choose: the edge is a discrete choice of band, and a bf16
    prediction may tip a band near the threshold."""
    sr = SAMPLE_RATE
    n_mels = log_mel_pred.shape[-1]
    dev = rl.device
    mag = torch.sqrt(rl * rl + il * il + 1e-20)
    fb = table(mel_filterbank, sr, n_fft, n_mels, device=dev)
    in_band = torch.log(torch.clamp(mag @ fb, min=1e-5)).mean(dim=-2)
    level = log_mel_pred.mean(dim=-2) - delta
    active = in_band > level
    peaks = table(mel_band_peaks, n_mels, device=dev)
    edge = torch.where(active, peaks, torch.zeros_like(peaks)).amax(dim=-1, keepdim=True)
    edge = torch.where(active.any(dim=-1, keepdim=True), edge, torch.full_like(edge, max_hz))
    cut = torch.clamp(edge, max=max_hz) / (sr / n_fft)
    bins = torch.arange(n_fft // 2 + 1, dtype=torch.float32, device=dev)
    # bands surely active, and bands a prediction within the margin may tip
    # either way.  Lowest edge: the highest sure band's peak; with no sure
    # band, the lowest tippable band's peak, or max_hz where none can tip.
    # Highest edge: the highest band that is or may be active, or max_hz
    # where no band is surely active (then none may be)
    sure_on = in_band > level + margin
    maybe = (in_band > level - margin) & ~sure_on
    zero, inf = torch.zeros_like(peaks), torch.full_like(peaks, float("inf"))
    has_sure = sure_on.any(dim=-1)
    lo = torch.where(has_sure, torch.where(sure_on, peaks, zero).amax(dim=-1),
                     torch.where(maybe, peaks, inf).amin(dim=-1))
    hi = torch.where(has_sure, torch.where(sure_on | maybe, peaks, zero).amax(dim=-1),
                     torch.full_like(lo, max_hz))
    edges = torch.stack([torch.clamp(lo, max=max_hz), torch.clamp(hi, max=max_hz)], dim=-1)
    return torch.sigmoid((cut - bins) / 4.0)[..., None, :], edges


# ---- resampling ---------------------------------------------------

@functools.lru_cache(maxsize=64)
def _resample_matrix(up: int, down: int, width: int = 64, rolloff: float = 0.945,
                     beta: float = 14.769):
    """Kaiser-windowed sinc at the upsampled rate as one dense block
    matrix ``[L + 2m, L*up/down]`` (``L`` a multiple of ``down``)."""
    w_c = rolloff * min(1.0, up / down) / (2.0 * up)
    half = int(math.ceil(width / (2.0 * w_c)))
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = 2.0 * w_c * np.sinc(2.0 * w_c * n) * np.kaiser(2 * half + 1, beta)
    h = (h / h.sum() * up).astype(np.float32)
    m = half // up + 1
    l = down * max(1, -(-512 // down))
    bout = l * up // down
    idx = np.arange(l + 2 * m)[:, None] * up - m * up - np.arange(bout)[None, :] * down + half
    valid = (idx >= 0) & (idx < h.shape[0])
    mat = np.zeros((l + 2 * m, bout), dtype=np.float32)
    mat[valid] = h[idx[valid]]
    return mat, l, bout, m


def _resample_table(up: int, down: int) -> np.ndarray:
    return _resample_matrix(up, down)[0]


def resample(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """``[C, S] -> [C, ceil(S*up/down)]``, output ``j`` at input time
    ``j*down/up`` (scipy ``resample_poly`` lengths)."""
    x = x.float()
    if src == dst:
        return x
    g = math.gcd(src, dst)
    up, down = dst // g, src // g
    _, l, bout, m = _resample_matrix(up, down)
    c, s = x.shape
    nb = -(-s // l)
    xp = F.pad(x, (m, m + nb * l - s))
    frames = frame_strided(xp, l + 2 * m, l)[:, :nb]
    y = frames @ table(_resample_table, up, down, device=x.device)
    return y.reshape(c, nb * bout)[:, :-(-s * up // down)]


# ---- chunking and overlap-add ---------------------------------------------

def iter_chunks(total: int, win: int, hop: int) -> List[Tuple[int, int]]:
    spans, i = [], 0
    while i < total:
        length = min(win, total - i)
        spans.append((i, length))
        if i + length >= total:
            break
        i += hop
    return spans


def chunk_batch(x: torch.Tensor, win: int, hop: int) -> Tuple[torch.Tensor, np.ndarray]:
    """``[C, S] -> ([K, C, win] zero-padded chunks, lengths [K])``."""
    c, total = x.shape
    spans = iter_chunks(total, win, hop)
    k = len(spans)
    lengths = np.array([l for _, l in spans], np.int64)
    x_pad = F.pad(x.float(), (0, (k - 1) * hop + win - total))
    chunks = frame_strided(x_pad, win, hop)[:, :k].transpose(0, 1)
    mask = torch.arange(win, device=x.device)[None, :] < torch.as_tensor(
        lengths, device=x.device)[:, None]
    return chunks * mask[:, None, :], lengths


def wola_stitch(preds: torch.Tensor, lengths: np.ndarray, total: int, hop: int) -> torch.Tensor:
    """Symmetric-Hann-weighted overlap-add of ``[K, C, win]`` chunk
    outputs on the ``i*hop`` grid (``win <= 2*hop``) -> ``[C, total]``,
    normalised by the summed weight (zero weight guarded to 1)."""
    k, c, win = preds.shape
    dev = preds.device
    valid = torch.arange(win, device=dev)[None, :] < torch.as_tensor(lengths, device=dev)[:, None]
    wgt = torch.where(valid, table(hann_symmetric, win, device=dev)[None, :], 0.0)
    acc = torch.zeros(c, (k + 1) * hop, device=dev)
    wsum = torch.zeros((k + 1) * hop, device=dev)
    for i in range(k):
        acc[:, i * hop: i * hop + win] += preds[i] * wgt[i]
        wsum[i * hop: i * hop + win] += wgt[i]
    acc, wsum = acc[:, :total], wsum[:total]
    return acc / torch.where(wsum == 0.0, torch.ones_like(wsum), wsum)[None, :]


# ---- JAX's threefry2x32 normal draw (the one-step noise latent) ------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _threefry(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0, x1 = x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``."""
    key = np.array([0, int(seed)], np.uint32)
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = _threefry(key, (idx >> np.uint64(32)).astype(np.uint32),
                           (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = b0 ^ b1
    one = np.array(1.0, np.float32).view(np.uint32)
    fl = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, (fl.astype(np.float64) * np.float64(np.float32(1.0) - lo)
                        + np.float64(lo)).astype(np.float32))
    w = -np.log1p(-u * u)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w.astype(np.float64)).astype(np.float32)
    e = np.where(np.abs(u) == 1.0, u * np.float32(np.inf), p * u).astype(np.float32)
    return (np.float32(np.sqrt(2)) * e).astype(np.float32).reshape(shape)
