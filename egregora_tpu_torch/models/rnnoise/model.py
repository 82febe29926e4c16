"""RNNoise-class denoiser, inference: the port of ``egregora_tpu/models/rnnoise/model.py``.

The same analysis, network and synthesis (denoise.c / pitch.c semantics,
48 kHz, 10 ms frames of 480 samples), on tensors of any device:

* DC-blocking biquad over the whole channel at PCM (±32768) scale;
* 960-sample Vorbis-windowed FFT over (previous, current) frame pairs,
  kiss-FFT's forward 1/N, 22 triangular bands, 50% overlap-add synthesis;
* pitch: 1728-sample rolling buffer, 2x decimation, normalised
  cross-correlation at every lag 60..768 as one FFT correlation, then
  the sub-multiple (doubling) rejection against the previous period;
* 42 features: 22 BFCC (first 6 the 3-frame cepstral sum), 6 first and 6
  second deltas, 6 DCT coefficients of the band pitch correlation,
  the pitch period and the cepstral spectral variability;
* dense(24, tanh) -> VAD GRU(24) -> noise GRU(48) -> denoise GRU(96) ->
  22 band gains and a VAD probability (sigmoid); gate order z, r, n and
  ``n = tanh(xn + r * (h @ W_hn))`` (no recurrent bias);
* pitch comb filter, band-energy renormalisation, gain floor ``max(g,
  0.6 lastg)``, triangular interpolation of the gains onto the bins;
* silence (band energy < 0.04): the frame passes through, and every
  carried state (GRUs, cepstral history, gain floor, pitch) is frozen.

Everything that does not depend on the frame recurrence runs batched over
all frames, as in the JAX package.  What is sequential are two loops of
plain PyTorch over frames: the pitch doubling rejection (it reads the
previous period) and the GRU chain.  The GRU loop keeps per step only
what depends on the recurrent state: the features, the dense layer and
every input projection that does not read a hidden state are computed
for all frames first; the cepstral history that the features read is the
last 8 non-silent frames, gathered in one pass from the silence mask.
The VAD and gain heads run after the loop on the stacked states; the gain
floor is a third loop of three ops a frame.  ``segments=N`` splits the
frames into N windows with a ``warmup``-frame halo of the real preceding
frames (synthetic silence before the first) and runs all windows (and
all channels) through one loop as a batch (``_segment_scan``).

Parameters are a nested dict (``init_params``, ``train.load_pretrained``,
``convert_rnnoise_tables``) of numpy arrays or tensors, in the JAX
package's flax layout (kernels ``[in, out]``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SR = 48000
FRAME = 480            # 10 ms
WINDOW = 2 * FRAME     # 960
FREQ = WINDOW // 2 + 1  # 481 bins at 50 Hz
NB_BANDS = 22
NB_FEATURES = 42
NB_DELTA = 6
CEPS_MEM = 8
PITCH_MIN = 60
PITCH_MAX = 768
PITCH_FRAME = 960
PITCH_BUF = PITCH_MAX + PITCH_FRAME        # 1728
PCM_SCALE = 32768.0                         # C operates on short-range floats
SILENCE_E = 0.04                            # denoise.c silence threshold
HP_B = (-1.99599, 0.99600)                  # denoise.c b_hp / a_hp
HP_A = (-1.98989, 0.98990)

# RNNoise eband5ms band edges, in units of 4 50-Hz bins (=200 Hz):
EBAND5MS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24,
                     28, 34, 40, 48, 60, 78, 100], dtype=np.int32)
BAND_BIN = EBAND5MS * 4   # bin index of each band center


@functools.lru_cache(maxsize=1)
def _vorbis_window() -> np.ndarray:
    """960-tap window: denoise.c's ``half_window`` (argument over
    FRAME_SIZE) on both halves, mirrored (Princen-Bradley at 50% OLA)."""
    i = np.arange(FRAME)
    s = np.sin(0.5 * np.pi * (i + 0.5) / FRAME)
    half = np.sin(0.5 * np.pi * s * s)
    return np.concatenate([half, half[::-1]]).astype(np.float32)


def _triangles() -> np.ndarray:
    m = np.zeros((FREQ, NB_BANDS), dtype=np.float32)
    for b in range(NB_BANDS - 1):
        lo, hi = BAND_BIN[b], BAND_BIN[b + 1]
        size = hi - lo
        for j in range(size):
            frac = j / size
            m[lo + j, b] += 1.0 - frac
            m[lo + j, b + 1] += frac
    return m


@functools.lru_cache(maxsize=1)
def _band_matrix_energy() -> np.ndarray:
    """``[FREQ, NB_BANDS]`` weights of compute_band_energy / _corr, with
    the first and last bands doubled as the C code does."""
    m = _triangles()
    m[:, 0] *= 2
    m[:, NB_BANDS - 1] *= 2
    return m


@functools.lru_cache(maxsize=1)
def _band_matrix_interp() -> np.ndarray:
    """``[FREQ, NB_BANDS]`` gain interpolation weights (interp_band_gain):
    plain triangles; bins above 20 kHz get zero gain."""
    return _triangles()


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """Orthonormal DCT-II ``[NB_BANDS, NB_BANDS]`` (denoise.c ``dct``)."""
    n = NB_BANDS
    m = np.zeros((n, n), dtype=np.float32)
    for k in range(n):
        for i in range(n):
            m[i, k] = np.cos(np.pi * k * (i + 0.5) / n)
        m[:, k] *= np.sqrt(2.0 / n)
    m[:, 0] /= np.sqrt(2.0)
    return m


def _const(fn, device) -> torch.Tensor:
    from ...ops.stft import device_tensor
    return device_tensor(fn, device=str(device))


@dataclasses.dataclass(frozen=True)
class RNNoiseConfig:
    dense_units: int = 24
    vad_gru: int = 24
    noise_gru: int = 48
    denoise_gru: int = 96


def init_params(seed: int = 0, cfg: RNNoiseConfig = RNNoiseConfig()) -> Dict:
    """Seeded parameter tree with RNNoise's layer topology: the JAX
    package's ``init_params(seed)`` draw for draw (its threefry PRNG in
    numpy, ``models.flashsr.prng``)."""
    from ..flashsr.prng import normal_from_key, prng_key, split

    k = split(prng_key(seed), 12)

    def g(key, shp):
        return normal_from_key(key, shp) * np.float32(1.0 / np.sqrt(shp[0]))

    c = cfg
    vad_in = c.dense_units
    noise_in = c.dense_units + c.vad_gru + NB_FEATURES
    den_in = c.vad_gru + c.noise_gru + NB_FEATURES
    zeros = lambda n: np.zeros((n,), np.float32)
    return {
        "input_dense": {"kernel": g(k[0], (NB_FEATURES, c.dense_units)),
                        "bias": zeros(c.dense_units)},
        "vad_gru": _gru_init(k[1], vad_in, c.vad_gru),
        "noise_gru": _gru_init(k[2], noise_in, c.noise_gru),
        "denoise_gru": _gru_init(k[3], den_in, c.denoise_gru),
        "denoise_output": {"kernel": g(k[4], (c.denoise_gru, NB_BANDS)),
                           "bias": zeros(NB_BANDS)},
        "vad_output": {"kernel": g(k[5], (c.vad_gru, 1)), "bias": zeros(1)},
    }


def _gru_init(key, in_dim: int, units: int) -> Dict:
    from ..flashsr.prng import normal_from_key, split

    k1, k2 = split(key)
    return {
        "kernel": normal_from_key(k1, (in_dim, 3 * units)) * np.float32(1.0 / np.sqrt(in_dim)),
        "recurrent": normal_from_key(k2, (units, 3 * units)) * np.float32(1.0 / np.sqrt(units)),
        "bias": np.zeros((3 * units,), np.float32),
    }


def params_on(params: Dict, device) -> Dict:
    """The tree's leaves as float32 tensors on ``device``."""
    if isinstance(params, dict):
        return {k: params_on(v, device) for k, v in params.items()}
    return torch.as_tensor(np.asarray(params) if not isinstance(params, torch.Tensor)
                           else params, dtype=torch.float32, device=device)


def _gru_update(h: torch.Tensor, xw: torch.Tensor, recurrent: torch.Tensor) -> torch.Tensor:
    """One GRU step from its input projection ``xw = x @ kernel + bias``
    (gate order z, r, n; no recurrent bias)."""
    u = h.shape[-1]
    hw = h @ recurrent
    zr = torch.sigmoid(xw[..., : 2 * u] + hw[..., : 2 * u])
    z, r = zr[..., :u], zr[..., u:]
    n = torch.tanh(torch.addcmul(xw[..., 2 * u:], r, hw[..., 2 * u:]))
    return torch.lerp(n, h, z)                       # z * h + (1 - z) * n


def _hold(silent: torch.Tensor, old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """A carry after one frame: frozen on a silent frame, else updated."""
    return torch.where(silent, old, new)


def _gru_step(p: Dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Standard GRU cell (RNNoise/Keras gate order: z, r, n)."""
    return _gru_update(h, x @ p["kernel"] + p["bias"], p["recurrent"])


# ---------------------------------------------------------------------------
# pitch analysis
# ---------------------------------------------------------------------------

_DS_TGT = PITCH_FRAME // 2        # 480-sample correlation target
_DS_MAX = PITCH_MAX // 2          # 384
_DS_MIN = PITCH_MIN // 2          # 30
_XC_FFT = 2048                    # pow2 linear-correlation FFT length


def _pitch_candidates(pitch_bufs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frame-parallel half of the pitch search: ``[..., PITCH_BUF]``
    -> ``(cand [..., 8] int64, gc [..., 8], g0 [...])``: the normalised
    cross-correlation of the newest 480 decimated samples at every lag,
    its best period T0 and the sub-multiples ``T0/k`` with their
    correlations."""
    b = pitch_bufs.float()
    # ds[i] = .5 b[2i] + .25 (b[2i-1] + b[2i+1]); b[-1] ~ b[0]
    ds = 0.5 * b[..., ::2] + 0.25 * (torch.cat([b[..., :1], b[..., 1:-2:2]], -1)
                                     + b[..., 1::2])
    tgt = ds[..., -_DS_TGT:]
    fb = torch.fft.rfft(ds, n=_XC_FFT)
    ft = torch.fft.rfft(tgt, n=_XC_FFT)
    c = torch.fft.irfft(fb * torch.conj(ft), n=_XC_FFT)[..., : _DS_MAX + 1]
    e_tgt = (tgt * tgt).sum(-1, keepdim=True)
    cs = F.pad(torch.cumsum(ds * ds, -1), (1, 0))
    e_lag = cs[..., _DS_TGT: _DS_TGT + _DS_MAX + 1] - cs[..., : _DS_MAX + 1]
    corr_all = c / torch.sqrt(e_tgt * e_lag + 1e-4)
    tau = _DS_MAX - torch.arange(_DS_MAX + 1, device=b.device)     # period at index
    valid = (tau >= _DS_MIN) & (tau <= _DS_MAX)
    corr = torch.where(valid, corr_all, torch.full_like(corr_all, -1.0))
    i0 = torch.argmax(corr, -1)
    t0 = _DS_MAX - i0
    g0 = corr.gather(-1, i0[..., None])[..., 0]
    ks = torch.arange(1, 9, device=b.device)
    cand = torch.round(t0[..., None] / ks).clamp(_DS_MIN, _DS_MAX).long()
    gc = corr.gather(-1, _DS_MAX - cand)
    return cand, gc, g0


def _pitch_select(cand: torch.Tensor, gc: torch.Tensor, g0: torch.Tensor,
                  prev_period: torch.Tensor, prev_gain: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential half (remove_doubling): the shortest sub-multiple
    whose correlation clears the threshold, with a continuity bonus near
    the previous period.  Batched over leading axes: ``cand``, ``gc``
    ``[..., 8]``, the rest ``[...]``."""
    cand2 = 2.0 * cand.float()
    return _select_doubling(cand2, gc, 0.77 * g0, prev_period, prev_gain,
                            torch.arange(8, device=gc.device))


def _select_doubling(cand2, gc, g077, prev_period, prev_gain, ar8):
    """``_pitch_select`` from its frame-only terms ``2 cand`` and
    ``0.77 g0``: (period, gain)."""
    near = (cand2 - prev_period[..., None]).abs() < torch.clamp_min(
        0.2 * prev_period, 10.0)[..., None]
    thresh = g077[..., None] - (0.15 * prev_gain)[..., None] * near
    ok = (gc > thresh) & (gc > 0.0)          # k = 1 is the fallback: index 0
    best = torch.where(ok, ar8, 0).amax(-1, keepdim=True)
    return cand2.gather(-1, best)[..., 0], gc.gather(-1, best)[..., 0].clamp(0.0, 1.0)


def _pitch_search(pitch_buf: torch.Tensor, prev_period: torch.Tensor,
                  prev_gain: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pitch period at 48 kHz, pitch gain) for ONE frame: the composition
    of the two halves."""
    cand, gc, g0 = _pitch_candidates(pitch_buf[None])
    return _pitch_select(cand[0], gc[0], g0[0], prev_period, prev_gain)


# ---------------------------------------------------------------------------
# features and the frame recurrences
# ---------------------------------------------------------------------------

def _log_band_follow(bande: torch.Tensor) -> torch.Tensor:
    """``Ly``: log10 band energies ``[..., 22]`` with denoise.c's
    max-follower chain over the bands."""
    ly = []
    log_max = torch.full_like(bande[..., 0], -2.0)
    follow = torch.full_like(bande[..., 0], -2.0)
    for i in range(NB_BANDS):
        v = torch.log10(1e-2 + bande[..., i])
        v = torch.maximum(log_max - 7.0, torch.maximum(follow - 1.5, v))
        log_max = torch.maximum(log_max, v)
        follow = torch.maximum(follow - 1.5, v)
        ly.append(v)
    return torch.stack(ly, -1)


def _windows(a: torch.Tensor, segments: int, warmup: int, fill) -> torch.Tensor:
    """``[B, F, ...] -> [B * segments, warmup + seg_len, ...]`` halo
    windows: ``warmup`` ``fill`` frames before the first, the tail padded
    with ``fill`` to ``segments * seg_len``."""
    b, f = a.shape[:2]
    seg_len = -(-f // segments)
    rest = a.shape[2:]
    ap = torch.cat([torch.full((b, warmup) + rest, fill, dtype=a.dtype, device=a.device), a,
                    torch.full((b, segments * seg_len - f) + rest, fill, dtype=a.dtype,
                               device=a.device)], 1)
    w = ap.unfold(1, warmup + seg_len, seg_len).movedim(-1, 2)
    return w.reshape((b * segments, warmup + seg_len) + rest)


def _segment_scan(run: Callable, xs: Sequence[torch.Tensor], silence: torch.Tensor,
                  segments: int, warmup: int) -> List[torch.Tensor]:
    """``run(xs, silence)`` (a frame loop over ``[N, F, ...]`` sequences,
    returning ``[N, F, ...]`` outputs) as ``segments`` windows batched
    through one loop, each warmed up over ``warmup`` real preceding frames
    (synthetic silence before segment 0, which every carry passes
    unchanged, so segment 0 is exact); outputs of the halo and of the
    tail padding are dropped.  ``xs`` and ``silence`` are ``[B, F, ...]``."""
    b, f = silence.shape
    if segments <= 1 or f < 2 * segments:
        return run(xs, silence)
    seg_len = -(-f // segments)
    ys = run([_windows(a, segments, warmup, 0) for a in xs],
             _windows(silence, segments, warmup, True))
    return [y.reshape((b, segments, warmup + seg_len) + y.shape[2:])[:, :, warmup:]
            .reshape((b, segments * seg_len) + y.shape[2:])[:, :f] for y in ys]


def _pitch_loop(xs: Sequence[torch.Tensor], silence: torch.Tensor) -> List[torch.Tensor]:
    """The doubling-rejection recurrence over frames: ``xs = (cand, gc,
    g0)`` ``[N, F, 8]``, ``[N, F, 8]``, ``[N, F]`` -> (periods, gains)
    ``[N, F]``; the previous period and gain are frozen on silence."""
    cand, gc, g0 = xs
    cand2, g077 = 2.0 * cand.float(), 0.77 * g0
    n, f = silence.shape
    ar8 = torch.arange(8, device=gc.device)
    prev_period = torch.full((n,), 300.0, device=gc.device)
    prev_gain = torch.zeros((n,), device=gc.device)
    periods, gains = [], []
    for t in range(f):
        period, gain = _select_doubling(cand2[:, t], gc[:, t], g077[:, t], prev_period,
                                        prev_gain, ar8)
        periods.append(period)
        gains.append(gain)
        s = silence[:, t]
        prev_period = _hold(s, prev_period, period)
        prev_gain = _hold(s, prev_gain, gain)
    return [torch.stack(periods, 1), torch.stack(gains, 1)]


def _cepstral_history(bfcc: torch.Tensor, silence: torch.Tensor) -> torch.Tensor:
    """``[N, F, 22] -> [N, F, CEPS_MEM, 22]``: at each frame the BFCCs of
    the last CEPS_MEM non-silent frames before it, newest first, zeros
    where there are fewer (the carried ``cep_mem`` of the scan)."""
    ns = ~silence
    before = torch.cumsum(ns.long(), 1) - ns.long()          # non-silent frames before t
    order = torch.argsort(silence.to(torch.int8), dim=1, stable=True)  # non-silent first
    hist = []
    for k in range(1, CEPS_MEM + 1):
        rank = before - k
        pos = order.gather(1, rank.clamp_min(0))
        h = bfcc.gather(1, pos[..., None].expand(-1, -1, bfcc.shape[-1]))
        hist.append(torch.where((rank >= 0)[..., None], h, torch.zeros_like(h)))
    return torch.stack(hist, 2)


def _features(bfcc: torch.Tensor, pitch_cep: torch.Tensor, period: torch.Tensor,
              silence: torch.Tensor) -> torch.Tensor:
    """The 42 features of every frame ``[N, F, 42]`` (zeros on silence)."""
    cep_mem = _cepstral_history(bfcc, silence)
    c1, c2 = cep_mem[:, :, 0], cep_mem[:, :, 1]
    head = bfcc[..., :NB_DELTA] + c1[..., :NB_DELTA] + c2[..., :NB_DELTA]
    d1 = (bfcc - c2)[..., :NB_DELTA]
    d2 = (bfcc - 2 * c1 + c2)[..., :NB_DELTA]
    new_mem = torch.cat([bfcc[:, :, None], cep_mem[:, :, :-1]], 2)
    dists = (new_mem[:, :, :, None, :] - new_mem[:, :, None, :, :]).square().sum(-1)
    dists = dists + torch.eye(CEPS_MEM, device=bfcc.device) * 1e15
    spec_var = dists.amin(-2).sum(-1) / CEPS_MEM - 2.1
    feats = torch.cat([head, bfcc[..., NB_DELTA:], d1, d2, pitch_cep,
                       (0.01 * (period - 300.0))[..., None], spec_var[..., None]], -1)
    return torch.where(silence[..., None], torch.zeros_like(feats), feats)


def _gru_loop(params: Dict, xs: Sequence[torch.Tensor], silence: torch.Tensor
              ) -> List[torch.Tensor]:
    """The GRU chain over frames: ``xs = (bfcc, pitch_cep, period)``
    -> (vad [N, F], gains [N, F, 22], floored gains [N, F, 22]); every
    carry frozen on silence.  Input projections of the features and the
    dense layer are computed for all frames first; a step does three
    recurrent matmuls, two input matmuls that read a new hidden state and
    the gate arithmetic."""
    bfcc, pitch_cep, period = xs
    feats = _features(bfcc, pitch_cep, period, silence)
    pd, pv, pn, pe = (params[k] for k in ("input_dense", "vad_gru", "noise_gru", "denoise_gru"))
    dense = torch.tanh(feats @ pd["kernel"] + pd["bias"])
    nd, nv = dense.shape[-1], pv["recurrent"].shape[0]
    xw_vad = dense @ pv["kernel"] + pv["bias"]
    k_noise = pn["kernel"]             # rows: dense | h_vad | feats
    xw_noise = dense @ k_noise[:nd] + feats @ k_noise[nd + nv:] + pn["bias"]
    k_noise_h = k_noise[nd: nd + nv]
    k_den = pe["kernel"]               # rows: h_vad | h_noise | feats
    nh = nv + pn["recurrent"].shape[0]
    xw_den = feats @ k_den[nh:] + pe["bias"]
    k_den_h = k_den[:nh].contiguous()
    n, f = silence.shape
    h_vad = feats.new_zeros(n, nv)
    h_noise = feats.new_zeros(n, pn["recurrent"].shape[0])
    h_den = feats.new_zeros(n, pe["recurrent"].shape[0])
    hv_seq, hd_seq = [], []
    for t in range(f):
        hv = _gru_update(h_vad, xw_vad[:, t], pv["recurrent"])
        hn = _gru_update(h_noise, torch.addmm(xw_noise[:, t], hv, k_noise_h), pn["recurrent"])
        hd = _gru_update(h_den, torch.addmm(xw_den[:, t], torch.cat([hv, hn], 1), k_den_h),
                         pe["recurrent"])
        hv_seq.append(hv)
        hd_seq.append(hd)
        s = silence[:, t, None]
        h_vad = _hold(s, h_vad, hv)
        h_noise = _hold(s, h_noise, hn)
        h_den = _hold(s, h_den, hd)
    vad = torch.sigmoid(torch.stack(hv_seq, 1) @ params["vad_output"]["kernel"]
                        + params["vad_output"]["bias"])[..., 0]
    gains = torch.sigmoid(torch.stack(hd_seq, 1) @ params["denoise_output"]["kernel"]
                          + params["denoise_output"]["bias"])
    lastg = gains.new_zeros(n, gains.shape[-1])
    floored = []
    for t in range(f):
        g = torch.maximum(gains[:, t], 0.6 * lastg)
        floored.append(g)
        lastg = _hold(silence[:, t, None], lastg, g)
    return [vad, gains, torch.stack(floored, 1)]


def _front_end(x: torch.Tensor):
    """``[B, T]`` float(±1) -> (spec [B, F, 481], band energies [B, F, 22],
    pitch windows [B, F, 1728]): the DC-blocked PCM-scale signal framed
    and transformed for every frame at once."""
    from ...ops.iir import biquad
    from ...ops.stft import frame_strided

    n_frames = x.shape[-1] // FRAME
    xs = biquad(x[..., : n_frames * FRAME].float() * PCM_SCALE, b=HP_B, a=HP_A)
    win = _const(_vorbis_window, x.device)
    bufs = frame_strided(F.pad(xs, (FRAME, 0)), WINDOW, FRAME)[..., :n_frames, :] * win
    spec = torch.fft.rfft(bufs) / WINDOW                       # kiss 1/N
    ex = _sqmag(spec) @ _const(_band_matrix_energy, x.device)
    pitch_bufs = frame_strided(F.pad(xs, (PITCH_BUF - FRAME, 0)), PITCH_BUF,
                               FRAME)[..., :n_frames, :]
    return spec, ex, pitch_bufs


def _sqmag(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def _denoise_batch(params: Dict, x: torch.Tensor, segments: int, warmup: int):
    """``denoise_channel_full`` over a batch of channels ``[B, T]``."""
    dev = x.device
    p = params_on(params, dev)
    win = _const(_vorbis_window, dev)
    bm_e = _const(_band_matrix_energy, dev)
    bm_i_t = _const(_band_matrix_interp, dev).T
    dct = _const(_dct_matrix, dev)

    spec_all, ex_all, pitch_bufs = _front_end(x)
    silence = ex_all.sum(-1) < SILENCE_E                        # [B, F]
    bfcc = _log_band_follow(ex_all) @ dct
    bfcc[..., 0] -= 12.0
    bfcc[..., 1] -= 4.0

    cand, gc, g0 = _pitch_candidates(pitch_bufs)
    periods, _ = _segment_scan(_pitch_loop, (cand, gc, g0), silence, segments, warmup)

    starts = (PITCH_BUF - WINDOW) - periods.long()
    idx = starts[..., None] + torch.arange(WINDOW, device=dev)
    p_spec = torch.fft.rfft(pitch_bufs.gather(-1, idx) * win) / WINDOW
    ep_all = _sqmag(p_spec) @ bm_e
    exp_num = (spec_all.real * p_spec.real + spec_all.imag * p_spec.imag) @ bm_e
    exp_all = exp_num / torch.sqrt(1e-3 + ex_all * ep_all)      # band pitch corr
    pitch_cep = (exp_all @ dct)[..., :NB_DELTA]
    pitch_cep[..., 0] -= 1.3
    pitch_cep[..., 1] -= 0.9

    vads, gains, gains_s = _segment_scan(functools.partial(_gru_loop, p),
                                         (bfcc, pitch_cep, periods), silence,
                                         segments, warmup)

    # pitch comb filter + band gains (denoise.c pitch_filter)
    g2 = gains * gains
    exp2 = exp_all * exp_all
    r = torch.where(exp_all > gains, torch.ones_like(gains),
                    exp2 * (1.0 - g2) / (1e-3 + g2 * (1.0 - exp2)))
    r = torch.sqrt(r.clamp(0.0, 1.0) + 1e-9) * torch.sqrt((ex_all + 1e-9) / (1e-8 + ep_all))
    spec_f = spec_all + (r @ bm_i_t) * p_spec
    new_e = _sqmag(spec_f) @ bm_e
    norm = torch.sqrt((ex_all + 1e-9) / (1e-8 + new_e))
    spec_f = spec_f * (norm @ bm_i_t)
    spec_out = spec_f * (gains_s @ bm_i_t)
    spec_out = torch.where(silence[..., None], spec_all, spec_out)
    vads = torch.where(silence, torch.zeros_like(vads), vads)

    # synthesis + 50% overlap-add: out frame t = yfr[t, :480] + yfr[t-1, 480:]
    yfr = torch.fft.irfft(spec_out * WINDOW, n=WINDOW) * win
    outs = yfr[..., :FRAME] + F.pad(yfr[..., :-1, FRAME:], (0, 0, 1, 0))
    out = outs.reshape(outs.shape[0], -1)[..., : x.shape[-1]] / PCM_SCALE
    return out, vads, gains, ex_all


def denoise_channel_full(params: Dict, x: torch.Tensor, segments: int = 1,
                         warmup: int = 100):
    """``x [T]`` (or a batch ``[B, T]``) -> (denoised [T], vad [F], rnn
    band gains [F, 22], analysis band energies [F, 22]), F = T // 480."""
    if x.ndim == 1:
        return tuple(y[0] for y in _denoise_batch(params, x[None], segments, warmup))
    return _denoise_batch(params, x, segments, warmup)


def denoise_channel(params: Dict, x: torch.Tensor, segments: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Denoise a mono 48 kHz float(±1) signal: ``x [T]`` (T a multiple of
    FRAME) -> (denoised [T], vad_probs [T // FRAME])."""
    out, vads, _, _ = denoise_channel_full(params, x, segments=segments)
    return out, vads


def denoise(params: Dict, x_cn: torch.Tensor, segments: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-channel denoise ``[C, T] -> ([C, T], [C, frames])``: every
    channel through one frame loop."""
    out, vads, _, _ = _denoise_batch(params, x_cn, segments, 100)
    return out, vads


def band_energies(x: torch.Tensor) -> torch.Tensor:
    """Per-frame analysis band energies ``[T] -> [frames, 22]`` through
    the same front end (biquad, PCM scale, Vorbis window, 1/N FFT)."""
    ex = _front_end(x.reshape(-1, x.shape[-1]))[1]
    return ex.reshape(x.shape[:-1] + ex.shape[-2:])


# ---------------------------------------------------------------------------
# xiph weight table conversion
# ---------------------------------------------------------------------------

_TABLE_LAYOUT = {
    # C model field -> (flax path, (rows, cols) in the C convention)
    "input_dense_weights": ("input_dense/kernel", (NB_FEATURES, 24)),
    "input_dense_bias": ("input_dense/bias", (24,)),
    "vad_gru_weights": ("vad_gru/kernel", (24, 72)),
    "vad_gru_recurrent_weights": ("vad_gru/recurrent", (24, 72)),
    "vad_gru_bias": ("vad_gru/bias", (72,)),
    "noise_gru_weights": ("noise_gru/kernel", (90, 144)),
    "noise_gru_recurrent_weights": ("noise_gru/recurrent", (48, 144)),
    "noise_gru_bias": ("noise_gru/bias", (144,)),
    "denoise_gru_weights": ("denoise_gru/kernel", (114, 288)),
    "denoise_gru_recurrent_weights": ("denoise_gru/recurrent", (96, 288)),
    "denoise_gru_bias": ("denoise_gru/bias", (288,)),
    "denoise_output_weights": ("denoise_output/kernel", (96, NB_BANDS)),
    "denoise_output_bias": ("denoise_output/bias", (NB_BANDS,)),
    "vad_output_weights": ("vad_output/kernel", (24, 1)),
    "vad_output_bias": ("vad_output/bias", (1,)),
}


def convert_rnnoise_tables(tables: Dict[str, np.ndarray]) -> Dict:
    """The xiph RNNoise weight tables (rnnoise_data.c arrays by model
    field, int8 tables already dequantized by /256) as this module's
    parameter tree; a missing field or a shape that is neither the C
    layout nor its transpose raises."""
    missing = [k for k in _TABLE_LAYOUT if k not in tables]
    if missing:
        raise ValueError(f"convert_rnnoise_tables: missing fields {missing}")
    out: Dict = {}
    for name, (path, shape) in _TABLE_LAYOUT.items():
        v = np.asarray(tables[name], np.float32)
        if v.shape != shape:
            if v.T.shape == shape:        # C stores [out, in] row-major
                v = v.T
            else:
                raise ValueError(f"{name}: shape {v.shape}, want {shape} (or transpose)")
        node = out
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(v)
    return out
