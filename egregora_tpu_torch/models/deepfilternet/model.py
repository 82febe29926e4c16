"""DeepFilterNet-class denoiser, inference: the port of
``egregora_tpu/models/deepfilternet/model.py``.

The same topology and arithmetic, on tensors of any device, in float32:

* STFT at 48 kHz: 960-point FFT, 480 hop, periodic Hann, 481 bins; the
  signal is padded by one window (``lead``) at the front and to whole
  frames at the back, ``(t + lead) // HOP + 1`` frames;
* 32 ERB bands (``erb_filterbank``: triangles equally spaced on the
  ERB-rate scale, the bins no triangle covers given to the edge bands,
  rows normalised to sum to one); a deep filter of order 5 over the
  first 96 bins;
* encoder: a stack of 2x3 convolutions over the ERB features, causal in
  time (one frame of zero history, on the left only) and padded (1, 1)
  in frequency, two of them with frequency stride 2 (32 -> 16 -> 8), a
  pair over the complex features of the low bins (96 -> 48), joined into
  a 256-wide embedding by linear layers;
* sequence model: DFN2's grouped GRU (8 independent GRUs over feature
  splits) or DFN3's squeezed GRU (grouped linear, ReLU -> one full-width
  GRU -> grouped linear, ReLU); the parameter tree's layout says which;
* ERB decoder: linear, two frequency-upsampling transposed convolutions
  with skips from the encoder, a 2x3 convolution and a sigmoid -> 32 band
  gains, optionally sharpened (post-filter, beta 0.02);
* deep-filter decoder: a GRU and a linear layer -> an order-5 complex FIR
  per low bin (scaled by 0.1) over the current and the four past frames,
  zero before the first, added to the gained low band;
* synthesis: inverse FFT, the window again, overlap-add on two shifted
  tracks, divided by the summed squared window where it is at least 1e-3
  of its peak (zero elsewhere).

The JAX package's ``vmap`` over channels is one batch dimension here.
Its GRUs (gate order z, r, n, no recurrent bias) run as one
``torch.nn.GRU`` recurrence each (``torch._VF.gru``, cuDNN's on the card)
on the parameters themselves, so a training step differentiates through
it: that computes the same function with the gate blocks in torch's (r,
z, n) order and a zero recurrent bias, and DFN2's eight grouped GRUs are
one GRU with block-diagonal weights.  Convolutions and GRUs run in full
float32 (``ops.fir.exact_f32``), not TF32.

Parameters are a nested dict of numpy arrays or tensors in the JAX
package's layout (``init_params``, ``train.load_pretrained``, or an
upstream state dict through the name maps and
``utils.weights.convert_state_dict``).
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.fir import exact_f32
from ...ops.stft import device_tensor, frame_strided, hann_periodic
from ..rnnoise.model import params_on

SR = 48000
N_FFT = 960
HOP = 480
FREQ = N_FFT // 2 + 1       # 481
NB_ERB = 32
NB_DF = 96                  # deep-filtered low bins (0..9.6 kHz)
DF_ORDER = 5
KT, KF = 2, 3               # causal time kernel, freq kernel


@dataclasses.dataclass(frozen=True)
class DFNConfig:
    """Per-variant topology: DFN2's grouped GRU, DFN3's squeezed GRU."""
    variant: str = "DeepFilterNet2"
    conv_ch: int = 64
    emb_dim: int = 256
    gru_groups: int = 8
    df_hidden: int = 256
    squeezed: bool = False      # DFN3 sequence-model layout
    linear_groups: int = 8      # grouped-linear groups (squeezed only)

    @staticmethod
    def for_variant(name: str) -> "DFNConfig":
        if str(name) == "DeepFilterNet3":
            return DFNConfig(variant="DeepFilterNet3", gru_groups=1,
                             squeezed=True, linear_groups=8)
        return DFNConfig(variant="DeepFilterNet2")


@functools.lru_cache(maxsize=1)
def erb_filterbank() -> np.ndarray:
    """``[FREQ, NB_ERB]`` triangular ERB-scale filterbank: bins outside
    every triangle (DC, Nyquist) belong to the edge bands, and each row
    sums to one."""
    def hz_to_erb(f):
        return 21.4 * np.log10(1.0 + 0.00437 * f)

    def erb_to_hz(e):
        return (10.0 ** (e / 21.4) - 1.0) / 0.00437

    freqs = np.linspace(0, SR / 2, FREQ)
    pts = erb_to_hz(np.linspace(hz_to_erb(0.0), hz_to_erb(SR / 2), NB_ERB + 2))
    fb = np.zeros((FREQ, NB_ERB), dtype=np.float32)
    for b in range(NB_ERB):
        lo, ctr, hi = pts[b], pts[b + 1], pts[b + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-6)
        dn = (hi - freqs) / max(hi - ctr, 1e-6)
        fb[:, b] = np.maximum(0.0, np.minimum(up, dn))
    empty = fb.sum(axis=1) < 1e-6     # incl. float-eps triangle tails
    fb[np.ix_(empty, range(NB_ERB))] = 0.0
    fb[empty & (freqs < SR / 4), 0] = 1.0
    fb[empty & (freqs >= SR / 4), NB_ERB - 1] = 1.0
    fb /= np.maximum(fb.sum(axis=1, keepdims=True), 1e-8)
    return fb


# ---------------------------------------------------------------------------
# parameter init: the JAX package's draws (its threefry PRNG in numpy)
# ---------------------------------------------------------------------------

def _normal(key, shape, fan_in: int) -> np.ndarray:
    from ..flashsr.prng import normal_from_key
    return normal_from_key(key, shape) / np.float32(np.sqrt(fan_in))


def _conv_init(key, cin: int, cout: int) -> Dict:
    return {"kernel": _normal(key, (KT, KF, cin, cout), KT * KF * cin),
            "bias": np.zeros((cout,), np.float32)}


def _lin_init(key, din: int, dout: int) -> Dict:
    return {"kernel": _normal(key, (din, dout), din), "bias": np.zeros((dout,), np.float32)}


def _gru_init(key, in_dim: int, units: int) -> Dict:
    from ..flashsr.prng import split
    k1, k2 = split(key)
    return {"kernel": _normal(k1, (in_dim, 3 * units), in_dim),
            "recurrent": _normal(k2, (units, 3 * units), units),
            "bias": np.zeros((3 * units,), np.float32)}


def _grouped_lin_init(key, groups: int, din: int, dout: int) -> Dict:
    return {"weight": _normal(key, (groups, din // groups, dout // groups), din // groups)}


def init_params(seed: int = 0, cfg: DFNConfig = DFNConfig()) -> Dict:
    """Seeded parameter tree: the JAX package's ``init_params(seed, cfg)``
    draw for draw."""
    from ..flashsr.prng import prng_key, split

    k = split(prng_key(seed), 20)
    c = cfg
    ch = c.conv_ch
    g = max(1, c.gru_groups)
    assert c.emb_dim % g == 0, "emb_dim must divide gru_groups"
    if c.squeezed:
        ks = split(k[8], 3)
        seq = {"gru_squeezed": {
            "lin_in": _grouped_lin_init(ks[0], c.linear_groups, c.emb_dim, c.emb_dim),
            "gru": _gru_init(ks[1], c.emb_dim, c.emb_dim),
            "lin_out": _grouped_lin_init(ks[2], c.linear_groups, c.emb_dim, c.emb_dim),
        }}
    else:
        seq = {"gru": {str(i): _gru_init(kk, c.emb_dim // g, c.emb_dim // g)
                       for i, kk in enumerate(split(k[8], g))}}
    return {
        **seq,
        "enc": {
            "erb_conv0": _conv_init(k[0], 1, ch),
            "erb_conv1": _conv_init(k[1], ch, ch),      # stride (1,2)
            "erb_conv2": _conv_init(k[2], ch, ch),      # stride (1,2)
            "erb_conv3": _conv_init(k[3], ch, ch),
            "df_conv0": _conv_init(k[4], 2, ch),
            "df_conv1": _conv_init(k[5], ch, ch),       # stride (1,2)
            "df_fc_emb": _lin_init(k[6], (NB_DF // 2) * ch, c.emb_dim),
            "emb_in": _lin_init(k[7], (NB_ERB // 4) * ch + c.emb_dim, c.emb_dim),
        },
        "erb_dec": {
            "emb_out": _lin_init(k[9], c.emb_dim, (NB_ERB // 4) * ch),
            "convt2": _conv_init(k[10], ch, ch),        # up x2 in freq
            "convt1": _conv_init(k[11], ch, ch),        # up x2 in freq
            "conv_out": _conv_init(k[12], ch, 1),
        },
        "df_dec": {
            "gru": _gru_init(k[13], c.emb_dim, c.df_hidden),
            "out": _lin_init(k[14], c.df_hidden, NB_DF * DF_ORDER * 2),
        },
    }


# ---------------------------------------------------------------------------
# layers (feature maps [B, C, T, F]; sequences [B, T, D])
# ---------------------------------------------------------------------------

def _conv(p: Dict, x: torch.Tensor, stride_f: int = 1) -> torch.Tensor:
    """Causal-in-time 2x3 conv ``[B, Ci, T, F] -> [B, Co, T, F/stride_f]``:
    time padded (1, 0), frequency (1, 1), as the JAX package's explicit
    padding."""
    pf = (KF - 1) // 2
    w = p["kernel"].permute(3, 2, 0, 1)                   # HWIO -> OIHW
    x = F.pad(x, (pf, KF - 1 - pf, KT - 1, 0))
    return F.conv2d(x, w, p["bias"], stride=(1, stride_f))


def _conv_t(p: Dict, x: torch.Tensor, stride_f: int = 2) -> torch.Tensor:
    """Frequency-upsampling transposed conv ``[B, Ci, T, F] -> [B, Co, T,
    F*stride_f]``: ``lax.conv_transpose`` (VALID, kernel as stored)
    correlates the zero-stuffed input, padded by k - 1 on both sides of
    both axes, with the kernel; ``conv_transpose2d`` with the kernel
    flipped on both axes (``[Ci, Co, KT, KF]``) is that.  Cropping to the
    first T frames keeps time causal."""
    t, f = x.shape[-2], x.shape[-1]
    w = p["kernel"].permute(2, 3, 0, 1).flip(2, 3)        # HWIO -> IOHW, flipped
    y = F.conv_transpose2d(x, w, stride=(1, stride_f))
    return y[..., :t, : f * stride_f] + p["bias"][:, None, None]


def _lin(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def _grouped_lin(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``[..., D] -> [..., O]`` through per-group projections (upstream
    ``GroupedLinearEinsum``)."""
    g, din_g, dout_g = p["weight"].shape
    xg = x.reshape(x.shape[:-1] + (g, din_g))
    return torch.einsum("...gi,gih->...gh", xg, p["weight"]).reshape(x.shape[:-1] + (g * dout_g,))


def _cudnn_gate_order(w: torch.Tensor) -> torch.Tensor:
    """Gate blocks on the last axis from (z, r, n) to torch's (r, z, n)."""
    u = w.shape[-1] // 3
    return torch.cat([w[..., u:2 * u], w[..., :u], w[..., 2 * u:]], -1)


def _torch_gru(kernel: torch.Tensor, recurrent: torch.Tensor, bias: torch.Tensor,
               xs: torch.Tensor) -> torch.Tensor:
    """A GRU over time, ``[B, T, I] -> [B, T, U]`` from a zero state, as one
    ``torch.nn.GRU`` recurrence (cuDNN on the card) with weights ``kernel
    [I, 3U]``, ``recurrent [U, 3U]`` and ``bias [3U]`` in the (z, r, n)
    layout; ``n = tanh(xn + r * (h @ W_hn))`` (zero recurrent bias).  The
    call takes the reordered weights as they are, so autograd records it:
    the weights and ``xs`` get their gradients through it."""
    u = recurrent.shape[0]
    flat = [_cudnn_gate_order(kernel).T.contiguous(), _cudnn_gate_order(recurrent).T.contiguous(),
            _cudnn_gate_order(bias), bias.new_zeros(3 * u)]
    h0 = xs.new_zeros(1, xs.shape[0], u)
    with warnings.catch_warnings():
        # the weights are not one flat cuDNN buffer: cuDNN copies them a call
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        # (input, h0, weights, biases, layers, dropout, train, bidirectional,
        # batch_first): training mode, as a new nn.GRU runs, so that the
        # recurrence can be differentiated
        return torch._VF.gru(xs, h0, flat, True, 1, 0.0, True, False, True)[0]


def _gru_scan(p: Dict, xs: torch.Tensor) -> torch.Tensor:
    return _torch_gru(p["kernel"], p["recurrent"], p["bias"], xs)


def _grouped_gru(groups: Dict, x: torch.Tensor) -> torch.Tensor:
    """DFN2's grouped recurrence: G independent GRUs over feature splits,
    concatenated, as one GRU whose weights are block-diagonal per gate
    (the zeros off the diagonal add exactly nothing)."""
    order = sorted(groups, key=int)

    def blocks(name):
        ws = [groups[i][name] for i in order]
        u = ws[0].shape[-1] // 3
        if ws[0].dim() == 1:
            return torch.cat([torch.cat([w[j * u:(j + 1) * u] for w in ws]) for j in range(3)])
        return torch.cat([torch.block_diag(*[w[:, j * u:(j + 1) * u] for w in ws])
                          for j in range(3)], 1)

    return _torch_gru(blocks("kernel"), blocks("recurrent"), blocks("bias"), x)


def _squeezed_gru(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """DFN3's SqueezedGRU_S: grouped linear, ReLU -> full-width GRU ->
    grouped linear, ReLU."""
    h = torch.relu(_grouped_lin(p["lin_in"], x))
    return torch.relu(_grouped_lin(p["lin_out"], _gru_scan(p["gru"], h)))


def _sequence_model(params: Dict, emb: torch.Tensor) -> torch.Tensor:
    """The tree's layout is the topology: squeezed (DFN3) or grouped (DFN2)."""
    if "gru_squeezed" in params:
        return _squeezed_gru(params["gru_squeezed"], emb)
    return _grouped_gru(params["gru"], emb)


def _shift_stack(x: torch.Tensor, order: int) -> torch.Tensor:
    """``[..., T, F] -> [..., T, F, order]`` of the frames t, t-1, ...,
    t-order+1, zero before the first."""
    t = x.shape[-2]
    parts = [x] + [F.pad(x, (0, 0, k, 0))[..., :t, :] for k in range(1, order)]
    return torch.stack(parts, -1)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _spectrum(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``[B, T]`` -> (spectrum ``[B, frames, FREQ]`` complex64, frames),
    with the ``N_FFT`` lead pad."""
    t = x.shape[-1]
    lead = N_FFT
    n_frames = max(1, (t + lead) // HOP + 1)
    xp = F.pad(x.float(), (lead, n_frames * HOP + N_FFT - t - lead))
    win = device_tensor(hann_periodic, N_FFT, device=str(x.device))
    frames = frame_strided(xp, N_FFT, HOP)[..., :n_frames, :] * win
    return torch.fft.rfft(frames, dim=-1), n_frames


def _sqmag(z: torch.Tensor) -> torch.Tensor:
    return z.real ** 2 + z.imag ** 2


def enhance_mono_full(params: Dict, x: torch.Tensor, post_filter: bool = False):
    """Denoise 48 kHz audio ``[T]`` or ``[B, T]`` -> (denoised, like ``x``;
    ERB gains ``[..., frames, 32]``; noisy band power ``[..., frames,
    32]``)."""
    if x.dim() == 1:
        return tuple(y[0] for y in enhance_mono_full(params, x[None], post_filter))
    with exact_f32():
        return _forward(params_on(params, x.device), x, post_filter)


def _forward(params: Dict, x: torch.Tensor, post_filter: bool):
    dev = str(x.device)
    b, t = x.shape
    lead = N_FFT
    spec, n_frames = _spectrum(x)                                      # [B, T, 481]
    fb = device_tensor(erb_filterbank, device=dev)
    pow_ = _sqmag(spec)
    erb_feat = (torch.log10(pow_ @ fb + 1e-10) + 4.0) / 3.0

    # ---- encoder ----
    enc = params["enc"]
    e0 = torch.tanh(_conv(enc["erb_conv0"], erb_feat[:, None]))       # [B,C,T,32]
    e1 = torch.tanh(_conv(enc["erb_conv1"], e0, stride_f=2))          # [B,C,T,16]
    e2 = torch.tanh(_conv(enc["erb_conv2"], e1, stride_f=2))          # [B,C,T,8]
    e3 = torch.tanh(_conv(enc["erb_conv3"], e2))                      # [B,C,T,8]

    low = spec[..., :NB_DF]
    mag = torch.sqrt(_sqmag(low) + 1e-10)
    unit = 1.0 / torch.sqrt(mag + 1e-3)
    df_feat = torch.stack([low.real * unit, low.imag * unit], 1)      # [B,2,T,96]
    c0 = torch.tanh(_conv(enc["df_conv0"], df_feat))                  # [B,C,T,96]
    c1 = torch.tanh(_conv(enc["df_conv1"], c0, stride_f=2))           # [B,C,T,48]

    def flat(m):                   # [B, C, T, F] -> [B, T, F*C], as [T, F, C] flattens
        return m.permute(0, 2, 3, 1).reshape(b, n_frames, -1)

    cemb = torch.tanh(_lin(enc["df_fc_emb"], flat(c1)))
    emb = torch.tanh(_lin(enc["emb_in"], torch.cat([flat(e3), cemb], -1)))   # [B,T,emb]

    hs = _sequence_model(params, emb)                                 # [B,T,emb]

    # ---- ERB gain decoder with pathway skips ----
    dec = params["erb_dec"]
    ch = e0.shape[1]
    d = torch.tanh(_lin(dec["emb_out"], hs)).reshape(b, n_frames, NB_ERB // 4, ch)
    d = d.permute(0, 3, 1, 2) + e3
    d = torch.tanh(_conv_t(dec["convt2"], d, stride_f=2)) + e1        # [B,C,T,16]
    d = torch.tanh(_conv_t(dec["convt1"], d, stride_f=2)) + e0        # [B,C,T,32]
    gains = torch.sigmoid(_conv(dec["conv_out"], d))[:, 0]            # [B,T,32]
    if post_filter:
        beta = 0.02
        gains = gains * (1.0 + beta) / (1.0 + beta * gains * gains)
    spec_g = spec * (gains @ fb.T)

    # ---- deep-filter decoder ----
    dfd = params["df_dec"]
    hdf = _gru_scan(dfd["gru"], hs)
    coefs = _lin(dfd["out"], hdf).reshape(b, n_frames, NB_DF, DF_ORDER, 2) * 0.1
    cplx = torch.complex(coefs[..., 0], coefs[..., 1])                # [B,T,96,5]
    df_out = (_shift_stack(spec[..., :NB_DF], DF_ORDER) * cplx).sum(-1)
    spec_out = torch.cat([spec_g[..., :NB_DF] + df_out, spec_g[..., NB_DF:]], -1)

    # ---- synthesis: two-track weighted overlap-add ----
    win = device_tensor(hann_periodic, N_FFT, device=dev)
    yfr = torch.fft.irfft(spec_out, n=N_FFT, dim=-1) * win
    acc = (F.pad(yfr[..., :HOP].reshape(b, -1), (0, HOP))
           + F.pad(yfr[..., HOP:].reshape(b, -1), (HOP, 0)))
    w2 = win * win
    wsum = (F.pad(w2[:HOP].repeat(n_frames), (0, HOP))
            + F.pad(w2[HOP:].repeat(n_frames), (HOP, 0)))
    keep = wsum >= 1e-3 * wsum.max()
    y = acc * keep / torch.where(keep, wsum, torch.ones_like(wsum))
    return y[:, lead: lead + t], gains, pow_ @ fb


def enhance_mono(params: Dict, x: torch.Tensor, post_filter: bool = False) -> torch.Tensor:
    """Denoise 48 kHz audio ``[T]`` (or ``[B, T]``) -> the same shape."""
    return enhance_mono_full(params, x, post_filter)[0]


def erb_band_energies(x: torch.Tensor) -> torch.Tensor:
    """``[T] -> [frames, 32]`` (or batched) linear ERB band power through
    the framing ``enhance_mono_full`` uses, its lead pad included."""
    spec, _ = _spectrum(x.reshape(-1, x.shape[-1]))
    e = _sqmag(spec) @ device_tensor(erb_filterbank, device=str(x.device))
    return e.reshape(x.shape[:-1] + e.shape[-2:])


def enhance(params: Dict, x_cn: torch.Tensor, cfg: DFNConfig = DFNConfig(),
            post_filter: bool = False) -> torch.Tensor:
    """``[C, T] -> [C, T]``: every channel through one batched pass."""
    return enhance_mono_full(params, x_cn, post_filter)[0]


# ---------------------------------------------------------------------------
# upstream checkpoint mapping
# ---------------------------------------------------------------------------

def _torch_gru_kernel(v):
    """torch GRU ``weight_ih/hh_l0`` ``[3h, d]`` in gate order (r, z, n)
    -> ``[d, 3h]`` in (z, r, n): transposed and the first two gate blocks
    swapped."""
    w = np.asarray(v).T
    h = w.shape[1] // 3
    return np.concatenate([w[:, h:2 * h], w[:, :h], w[:, 2 * h:]], axis=1)


def _torch_gru_bias(v):
    b = np.asarray(v)
    h = b.shape[0] // 3
    return np.concatenate([b[h:2 * h], b[:h], b[2 * h:]])


# torch checkpoint key -> '/'-joined path in this parameter tree (kernels
# transposed by convert_state_dict's shape logic); upstream DeepFilterNet2
# module names
DF_NAME_MAP = {
    "enc.erb_conv0.conv.weight": "enc/erb_conv0/kernel",
    "enc.erb_conv0.conv.bias": "enc/erb_conv0/bias",
    "enc.erb_conv1.conv.weight": "enc/erb_conv1/kernel",
    "enc.erb_conv1.conv.bias": "enc/erb_conv1/bias",
    "enc.erb_conv2.conv.weight": "enc/erb_conv2/kernel",
    "enc.erb_conv2.conv.bias": "enc/erb_conv2/bias",
    "enc.erb_conv3.conv.weight": "enc/erb_conv3/kernel",
    "enc.erb_conv3.conv.bias": "enc/erb_conv3/bias",
    "enc.df_conv0.conv.weight": "enc/df_conv0/kernel",
    "enc.df_conv0.conv.bias": "enc/df_conv0/bias",
    "enc.df_conv1.conv.weight": "enc/df_conv1/kernel",
    "enc.df_conv1.conv.bias": "enc/df_conv1/bias",
    "enc.df_fc_emb.weight": "enc/df_fc_emb/kernel",
    "enc.df_fc_emb.bias": "enc/df_fc_emb/bias",
    "enc.emb_in.weight": "enc/emb_in/kernel",
    "enc.emb_in.bias": "enc/emb_in/bias",
    "erb_dec.emb_out.weight": "erb_dec/emb_out/kernel",
    "erb_dec.emb_out.bias": "erb_dec/emb_out/bias",
    "erb_dec.convt2.conv.weight": "erb_dec/convt2/kernel",
    "erb_dec.convt2.conv.bias": "erb_dec/convt2/bias",
    "erb_dec.convt1.conv.weight": "erb_dec/convt1/kernel",
    "erb_dec.convt1.conv.bias": "erb_dec/convt1/bias",
    "erb_dec.conv_out.conv.weight": "erb_dec/conv_out/kernel",
    "erb_dec.conv_out.conv.bias": "erb_dec/conv_out/bias",
    "df_dec.df_gru.weight_ih_l0": ("df_dec/gru/kernel", _torch_gru_kernel),
    "df_dec.df_gru.weight_hh_l0": ("df_dec/gru/recurrent", _torch_gru_kernel),
    "df_dec.df_gru.bias_ih_l0": ("df_dec/gru/bias", _torch_gru_bias),
    "df_dec.df_out.weight": "df_dec/out/kernel",
    "df_dec.df_out.bias": "df_dec/out/bias",
}


def grouped_gru_name_map(groups: int):
    """Per-group GRU entries: ``emb_gru.gru_{i}.*`` -> ``gru/{i}/*``."""
    m = {}
    for i in range(groups):
        m[f"emb_gru.gru_{i}.weight_ih_l0"] = (f"gru/{i}/kernel", _torch_gru_kernel)
        m[f"emb_gru.gru_{i}.weight_hh_l0"] = (f"gru/{i}/recurrent", _torch_gru_kernel)
        m[f"emb_gru.gru_{i}.bias_ih_l0"] = (f"gru/{i}/bias", _torch_gru_bias)
    return m


def dfn3_name_map():
    """DFN3's squeezed-GRU entries (upstream ``SqueezedGRU_S``:
    ``emb_gru.linear_in/gru/linear_out``; the grouped linear weights are
    ``[G, in/G, out/G]`` on both sides) plus ``DF_NAME_MAP``."""
    m = dict(DF_NAME_MAP)
    m["emb_gru.linear_in.weight"] = "gru_squeezed/lin_in/weight"
    m["emb_gru.gru.weight_ih_l0"] = ("gru_squeezed/gru/kernel", _torch_gru_kernel)
    m["emb_gru.gru.weight_hh_l0"] = ("gru_squeezed/gru/recurrent", _torch_gru_kernel)
    m["emb_gru.gru.bias_ih_l0"] = ("gru_squeezed/gru/bias", _torch_gru_bias)
    m["emb_gru.linear_out.weight"] = "gru_squeezed/lin_out/weight"
    return m
