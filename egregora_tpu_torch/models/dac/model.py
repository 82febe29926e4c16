"""Descript Audio Codec (DAC), inference: the port of
``egregora_tpu/models/dac/model.py``.

The same architecture; tensors keep PyTorch's logical ``[B, C, T]``
shapes, laid out channels-last in memory (below):

* encoder: a 7-tap conv stem, then per stride s a block of three
  Snake-activated residual units (dilations 1, 3, 9), a Snake and a conv
  of kernel 2s and stride s that doubles the channels; a Snake and a
  3-tap conv to the latent;
* residual vector quantizer: per stage a float32 projection to the
  codebook dimension, the nearest of the 1024 codes (squared distance,
  ``argmin``), the projection back, subtracted from the residual;
* decoder: a 7-tap conv stem, then per stride (reversed) a Snake, a
  transposed conv of kernel 2s and stride s that halves the channels and
  three residual units; a Snake, a 7-tap conv to one channel and, where
  the configuration says so, a tanh.

Convolutions follow flax's defaults (``models.flashsr.layers``): 'SAME'
padding, which at kernel 2s and stride s pads (s // 2, s - s // 2), so
(2, 3) at stride 5; ``ConvTranspose`` as flax computes it
(``transpose_kernel=False``); each conv casts its input, kernel and bias
to ``cfg.dtype`` (bf16 unless the configuration says otherwise) and
returns that dtype.

**Layout.** Every activation from the encoder's input to the decoder's
output is channels-last: ``[B, C, T]`` with strides ``(T C, 1, C)``, the
memory of ``[B, T, C]`` (``nwc``).  The edges cost nothing: the encoder's
input and the decoder's output have one channel, where both layouts are
the same memory; the encoder's output, transposed in ``encode``, is the
contiguous ``[B, T, D]`` the quantizer reads; ``decode``'s transpose of
the contiguous latents is already channels-last.  The DAC's convs
(``Conv1dNWC``, ``ConvTranspose1dNWC``: ``layers.Conv1d`` and
``ConvTranspose1d`` with their parameters, another ``forward``) run as
the 4-D ops on the ``[B, C, 1, T]`` view in ``torch.channels_last``, so
that cuDNN takes them in NHWC on its Hopper kernels with no transpose in
or out (PyTorch's ``conv1d`` makes a 3-D input contiguous, NCW, first).
Two shapes need more to stay there: the dilation-9 convs run as the
undilated 7-tap conv on the ``[T / 9, 9]`` view of the same memory, and
the stem's one input channel and the last conv's one output are padded
with zeros to 8.  Snake's kernel reads and writes either layout.  A copy
that changes an activation's layout (a conv or Snake handed another
layout, a pad or crop that returns one) is counted as
``dac_layout_copies``; a call makes none.

Snake's alpha is a float32 parameter, so ``x +
sin^2(alpha x) / (alpha + 1e-9)`` is computed in float32; each Snake
returns ``cfg.dtype``, the dtype of the conv it feeds, rounded once
(``ops.snake``: the hand-written kernel on the card, the plain version on
the CPU), so the conv's cast of its input is a no-op.  The residual adds
keep the dtype the JAX package's promotion gives them.  Modules are
named as flax names them (``Conv_0``, ``EncoderBlock_1``, ``Snake_0``,
``proj_in_3``, ``codebook_3``), so ``dac_params_from_jax`` maps a flax tree
key for key.

``build_dac`` resolves weights per model type, cached: a converted
checkpoint at ``utils.weights.weights_dir() / f"dac_{type}.npz"`` (the
JAX package's ``save_params`` layout) first, then the codec a guarded run
of the port shipped (``train.output_path``), then the JAX package's
shipped compact codec (``train.load_pretrained`` serves those two), else a
seeded random init with a warning.  ``DACModel.init_params(seed)`` is flax's init of the
JAX package's modules, draw for draw (``flax_init``), so a from-scratch
training run starts from the JAX package's weights.

The quantizer has the JAX package's training mode (``with_losses``,
``collect_stage_data``: the commitment and codebook terms, the
straight-through estimator, the per-stage residuals); ``encode`` and
``decode`` are inference (no gradient), and a trainer calls the three
modules directly (``train.py``).

Spans and counters (``utils.profiling``; they record only while a
profiler session or ``recording()`` does): ``egr.dac.encoder`` (counting
``dac_frames``, codec frames times channels), ``egr.dac.rvq`` and
``egr.dac.decoder`` in ``encode`` and ``decode``, and ``egr.dac.snake``
around each Snake (29 in the encoder and 29 in the decoder at four
strides), which on the card counts ``snake_launches``, one a Snake;
``dac_layout_copies`` in the innermost open span, where a layout copy
is made.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.fir import exact_f32
from ...ops.snake import snake as snake_op
from ...ops.snake import snake_plain as snake  # noqa: F401  (the plain version, under its old name)
from ...utils.profiling import count, span
from ..flashsr import layers
from ..flashsr.layers import Conv1d, ConvTranspose1d, Dense


@dataclasses.dataclass(frozen=True)
class DACConfig:
    sample_rate: int = 44100
    encoder_dim: int = 64
    strides: Sequence[int] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    res_scale: float = 1.0         # residual-branch scale (0.5 in the shipped codecs)
    output_tanh: bool = True       # upstream decoders end in tanh
    alpha_floor: float = 0.0       # Snake alpha floor (0.05 in the shipped codecs)
    dtype: torch.dtype = torch.bfloat16

    @property
    def latent_dim(self) -> int:
        return self.encoder_dim * (2 ** len(self.strides))

    @property
    def hop(self) -> int:
        h = 1
        for s in self.strides:
            h *= s
        return h


MODEL_TYPES = {
    "44khz": DACConfig(sample_rate=44100, strides=(2, 4, 8, 8)),
    "24khz": DACConfig(sample_rate=24000, strides=(2, 4, 5, 8)),
    "16khz": DACConfig(sample_rate=16000, strides=(2, 4, 5, 8)),
}


def nwc(x: torch.Tensor) -> torch.Tensor:
    """``x [B, C, T]`` laid out channels-last (strides ``(T C, 1, C)``):
    ``x`` itself where it is, else a copy, counted as ``dac_layout_copies``."""
    if x.transpose(1, 2).is_contiguous():
        return x
    count("dac_layout_copies")
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, T]`` as the ``[B, C, 1, T]`` view in ``torch.channels_last``."""
    return nwc(x).unsqueeze(2)


# cuDNN's NHWC tensor-core kernels take channel counts in multiples of
# this; a conv with another count (the stem's one input channel, the last
# conv's one output) falls back to a transposing or a legacy kernel
CHANNEL_GROUP = 8
# the dilation from which a conv runs as the undilated conv on the [T/d, d]
# view: at dilation 9 cuDNN's NHWC heuristic picks a direct kernel 200-400x
# slower than the view's implicit GEMM at 192-768 channels (H100, cuDNN 9.2)
VIEW_DILATION = 9


def _pad_channels(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x [B, C, T]`` in ``dtype`` with zero channels after its own up to a
    multiple of ``CHANNEL_GROUP``, channels-last (one cast-and-copy)."""
    b, c, t = x.shape
    out = x.new_zeros((b, t, -(-c // CHANNEL_GROUP) * CHANNEL_GROUP), dtype=dtype)
    out[..., :c].copy_(x.transpose(1, 2))
    return out.transpose(1, 2)


def _rows_copy(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst [B, T', C]`` holding ``src [B, T, C]``'s rows: the first ``T'``
    where ``T' <= T`` (a crop), else all of them and zero rows after (a
    pad); a contiguous copy a batch row (one strided copy of the whole
    would take PyTorch's slower kernel)."""
    n = min(src.shape[1], dst.shape[1])
    dst[:, n:].zero_()
    for i in range(src.shape[0]):
        dst[i, :n].copy_(src[i, :n])
    return dst


def _dilated_as_view(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     d: int) -> torch.Tensor:
    """The 'SAME' conv of channels-last ``x [B, C, T]`` with odd-tap ``w
    [Co, C, k]`` at dilation ``d``, as the undilated ``(k, 1)`` conv on the
    ``[T / d, d]`` view of the same memory (``t = h d + w``: the taps of
    ``t`` at ``t + j d`` are those of ``(h, w)`` at ``(h + j, w)``), the
    rows zero-padded to a multiple of ``d`` where ``T`` is not one and the
    output cropped back."""
    bsz, c, t = x.shape
    tp = -(-t // d) * d
    xt = x.transpose(1, 2)                                    # [B, T, C]
    if tp != t:
        xt = _rows_copy(xt, x.new_empty((bsz, tp, c)))
    xv = xt.view(bsz, tp // d, d, c).permute(0, 3, 1, 2)      # [B, C, T/d, d] NHWC
    del xt
    wv = w.unsqueeze(3).to(x.dtype, memory_format=torch.channels_last)
    y = F.conv2d(xv, wv, b.to(x.dtype), 1, ((w.shape[-1] - 1) // 2, 0))
    del xv                                                    # the padded copy, before the crop
    y = y.permute(0, 2, 3, 1).reshape(bsz, tp, -1)            # [B, T', Co]
    if tp != t:
        y = _rows_copy(y, y.new_empty((bsz, t, y.shape[-1])))
    return y.transpose(1, 2)


class Conv1dNWC(Conv1d):
    """``layers.Conv1d`` on channels-last ``[B, C, T]``: ``conv2d`` on the
    NHWC view, the 'SAME' pads in the call where they are even, else an
    ``F.pad`` of the view first (the stride-5 convs' (2, 3)); from
    ``VIEW_DILATION`` on, the undilated conv on the ``[T / d, d]`` view
    (``_dilated_as_view``); channels that are not a multiple of
    ``CHANNEL_GROUP`` padded with zeros (zero input channels and zero
    kernel rows add exact zeros) and the output's cropped back."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        co, ci = self.weight.shape[:2]
        w, b = self.weight, self.bias
        if ci % CHANNEL_GROUP:
            x = _pad_channels(nwc(x), self.dtype)
            w = F.pad(w, (0, 0, 0, x.shape[1] - ci))
        else:
            x = nwc(x).to(self.dtype)
        if co % CHANNEL_GROUP:
            extra = -co % CHANNEL_GROUP
            w, b = F.pad(w, (0, 0, 0, 0, 0, extra)), F.pad(b, (0, extra))
        if self.dilation >= VIEW_DILATION and self.stride == 1 and self.k % 2:
            y = _dilated_as_view(x, w, b, self.dilation)
        else:
            x4 = x.unsqueeze(2)
            lo, hi = layers.same_pads(x.shape[-1], self.k, self.stride, self.dilation)
            if lo != hi:
                x4, lo = _nhwc(F.pad(x4, (lo, hi)).squeeze(2)), 0
            w4 = w.unsqueeze(2).to(self.dtype, memory_format=torch.channels_last)
            y = F.conv2d(x4, w4, b.to(self.dtype), (1, self.stride), (0, lo),
                         (1, self.dilation)).squeeze(2)
        if co % CHANNEL_GROUP:
            y = y[:, :co].transpose(1, 2).contiguous().transpose(1, 2)
        return nwc(y)


class ConvTranspose1dNWC(ConvTranspose1d):
    """``layers.ConvTranspose1d`` on channels-last ``[B, C, T]``:
    ``conv_transpose2d`` on the NHWC view, flax's window cut out of the full
    output by the call's padding (which needs the window inside the full
    output: the codec's kernels of 2s at stride s), an odd stride's one
    extra sample cropped, and the bias added in the same pass."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, cout, k, stride, dtype)
        # flax's output o is the full output's o + p
        self.p = k - 1 - layers.conv_transpose_pads(k, stride)[0]
        if not 0 <= self.p <= k - stride:
            raise ValueError(f"ConvTranspose1dNWC: flax's window at kernel {k}, stride {stride} "
                             f"is not inside the full output")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] * self.stride
        w = self.weight.unsqueeze(2).to(self.dtype, memory_format=torch.channels_last)
        b = self.bias.to(self.dtype)[:, None, None]
        y = F.conv_transpose2d(_nhwc(x.to(self.dtype)), w, stride=(1, self.stride),
                               padding=(0, self.p))
        y = y.add_(b) if y.shape[-1] == n else y[..., :n] + b
        return nwc(y.squeeze(2))


class Snake(nn.Module):
    """Snake returning ``out_dtype``, the dtype of the conv it feeds, in
    the channels-last layout it reads."""

    def __init__(self, channels: int, floor: float, out_dtype: torch.dtype):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))
        self.floor, self.out_dtype = floor, out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("egr.dac.snake"):
            return snake_op(nwc(x), self.alpha, self.floor, self.out_dtype)


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int, cfg: DACConfig):
        super().__init__()
        self.Snake_0 = Snake(channels, cfg.alpha_floor, cfg.dtype)
        self.Conv_0 = Conv1dNWC(channels, channels, 7, dilation, cfg.dtype)
        self.Snake_1 = Snake(channels, cfg.alpha_floor, cfg.dtype)
        self.Conv_1 = Conv1dNWC(channels, channels, 1, 1, cfg.dtype)
        self.res_scale = cfg.res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_1(self.Snake_1(self.Conv_0(self.Snake_0(x))))
        return x + self.res_scale * h


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, cfg: DACConfig):
        super().__init__()
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"ResidualUnit_{i}", ResidualUnit(cin, d, cfg))
        self.Snake_0 = Snake(cin, cfg.alpha_floor, cfg.dtype)
        self.Conv_0 = Conv1dNWC(cin, cout, 2 * stride, 1, cfg.dtype, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"ResidualUnit_{i}")(x)
        return self.Conv_0(self.Snake_0(x))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, cfg: DACConfig):
        super().__init__()
        self.Snake_0 = Snake(cin, cfg.alpha_floor, cfg.dtype)
        self.ConvTranspose_0 = ConvTranspose1dNWC(cin, cout, 2 * stride, stride, cfg.dtype)
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"ResidualUnit_{i}", ResidualUnit(cout, d, cfg))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(self.Snake_0(x))
        for i in range(3):
            x = getattr(self, f"ResidualUnit_{i}")(x)
        return x


class DACEncoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        c = cfg
        self.Conv_0 = Conv1dNWC(1, c.encoder_dim, 7, 1, c.dtype)
        ch = c.encoder_dim
        for i, s in enumerate(c.strides):
            self.add_module(f"EncoderBlock_{i}", EncoderBlock(ch, 2 * ch, s, c))
            ch *= 2
        self.Snake_0 = Snake(ch, c.alpha_floor, c.dtype)
        self.Conv_1 = Conv1dNWC(ch, c.latent_dim, 3, 1, c.dtype)
        self.n_blocks = len(c.strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T] -> [B, latent_dim, T / hop]`` float32."""
        h = self.Conv_0(x)
        for i in range(self.n_blocks):
            h = getattr(self, f"EncoderBlock_{i}")(h)
        return self.Conv_1(self.Snake_0(h)).float()


class DACDecoder(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        c = cfg
        self.Conv_0 = Conv1dNWC(c.latent_dim, c.decoder_dim, 7, 1, c.dtype)
        ch = c.decoder_dim
        for i, s in enumerate(reversed(c.strides)):
            self.add_module(f"DecoderBlock_{i}", DecoderBlock(ch, ch // 2, s, c))
            ch //= 2
        self.Snake_0 = Snake(ch, c.alpha_floor, c.dtype)
        self.Conv_1 = Conv1dNWC(ch, 1, 7, 1, c.dtype)
        self.n_blocks, self.output_tanh = len(c.strides), c.output_tanh

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """``[B, latent_dim, T / hop] -> [B, T]`` float32."""
        h = self.Conv_0(z)
        for i in range(self.n_blocks):
            h = getattr(self, f"DecoderBlock_{i}")(h)
        h = self.Conv_1(self.Snake_0(h)).float()[:, 0]
        return torch.tanh(h) if self.output_tanh else h


class ResidualVQ(nn.Module):
    """Residual vector quantization with projected codebooks."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        c = cfg
        for i in range(c.n_codebooks):
            self.add_module(f"proj_in_{i}", Dense(c.latent_dim, c.codebook_dim, torch.float32))
            self.add_module(f"proj_out_{i}", Dense(c.codebook_dim, c.latent_dim, torch.float32))
            self.register_parameter(f"codebook_{i}", nn.Parameter(
                torch.empty(c.codebook_size, c.codebook_dim)))
        self.n_codebooks = c.n_codebooks

    def forward(self, z: torch.Tensor, with_losses: bool = False,
                collect_stage_data: bool = False) -> Tuple[torch.Tensor, ...]:
        """``[B, T, D] -> (z_q [B, T, D], codes [B, n_q, T])``.

        ``with_losses`` (training) adds ``(commit, codebook)``: per stage
        ``mean((r - sg(q_r))^2)`` and ``mean((sg(r) - q_r)^2)`` in the
        projected space, each over ``sg(mean(r^2)) + 1e-6``, and passes
        ``q_r`` on straight through (``r + sg(q_r - r)``), so the
        decoder's gradient reaches ``proj_in`` and the encoder;
        ``collect_stage_data`` adds ``r_stack [n_q, B, T, d]``, the
        per-stage projected residuals (detached) that the EMA codebook
        update reads."""
        residual, z_q, codes, r_stages = z, torch.zeros_like(z), [], []
        commit = codebook_loss = 0.0
        for i in range(self.n_codebooks):
            book = getattr(self, f"codebook_{i}")
            r = getattr(self, f"proj_in_{i}")(residual)                 # [B, T, d]
            d2 = (r.square().sum(-1, keepdim=True) - (2.0 * r) @ book.T
                  + book.square().sum(-1))                              # [B, T, K]
            idx = d2.argmin(-1)
            q_r = book[idx]
            if collect_stage_data:
                r_stages.append(r.detach())
            if with_losses:
                denom = r.square().mean().detach() + 1e-6
                commit = commit + (r - q_r.detach()).square().mean() / denom
                codebook_loss = codebook_loss + (r.detach() - q_r).square().mean() / denom
                q_r = r + (q_r - r).detach()
            q = getattr(self, f"proj_out_{i}")(q_r)
            z_q = z_q + q
            residual = residual - q
            codes.append(idx)
        out = (z_q, torch.stack(codes, 1))
        if with_losses:
            out += (commit, codebook_loss)
        if with_losses and collect_stage_data:
            out += (torch.stack(r_stages, 0),)
        return out


class DACModel(nn.Module):
    """The encoder, quantizer and decoder of one codec; ``weight_source``
    says where ``build_dac`` found its weights (``converted``,
    ``shipped`` or ``random``)."""

    def __init__(self, cfg: DACConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = DACEncoder(cfg)
        self.decoder = DACDecoder(cfg)
        self.rvq = ResidualVQ(cfg)
        self.weight_source = "random"

    def init_params(self, seed: int = 0) -> "DACModel":
        """Seeded weights in place: the JAX package's ``init_params(seed)``
        (flax's ``init`` of the three modules from ``split(PRNGKey(seed),
        3)``), draw for draw (``flax_init``)."""
        from ..flashsr.prng import prng_key, split
        names = ("encoder", "decoder", "rvq")
        tree = {name: flax_init(getattr(self, name), key)
                for name, key in zip(names, split(prng_key(seed), 3))}
        out_conv = tree["decoder"]["params"]["Conv_1"]     # flax's zero-initialised output conv
        out_conv["kernel"] = np.zeros_like(out_conv["kernel"])
        return self.load_jax(tree)

    def load_jax(self, flax_params: Dict[str, Any]) -> "DACModel":
        """Load the JAX package's parameter tree (``{"encoder", "decoder",
        "rvq"}``, numpy leaves)."""
        for name, sd in dac_params_from_jax(self.cfg, flax_params).items():
            getattr(self, name).load_state_dict(sd)
        return self

    @property
    def device(self) -> torch.device:
        return self.decoder.Conv_0.weight.device

    def preprocess(self, x_ct: torch.Tensor) -> torch.Tensor:
        """Right-pad ``[C, T]`` to a hop multiple."""
        return F.pad(x_ct, (0, (-x_ct.shape[-1]) % self.cfg.hop))

    @torch.no_grad()
    def encode(self, x_ct: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[C, T] -> (z_q [C, T/hop, D] float32, codes [C, n_q, T/hop])``,
        on the model's device."""
        x = self.preprocess(x_ct.float().to(self.device))
        with exact_f32():
            with span("egr.dac.encoder"):
                z = self.encoder(x[:, None]).transpose(1, 2)
                count("dac_frames", z.shape[0] * z.shape[1])
            with span("egr.dac.rvq"):
                return self.rvq(z)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[C, T/hop, D] -> [C, T]`` float32, on the model's device."""
        with exact_f32(), span("egr.dac.decoder"):
            return self.decoder(z.float().to(self.device).transpose(1, 2))


def _scope_key(root: np.ndarray, path: Tuple[str, ...], counter: int) -> np.ndarray:
    """flax's key for the ``counter``-th ``make_rng("params")`` of the scope
    at ``path`` under the root key: ``fold_in(root, first 4 bytes of
    SHA-1(path names, then the counter as big-endian bytes))``
    (``flax.core.scope.LazyRng`` / ``_fold_in_static``, no separators)."""
    from ..flashsr.prng import fold_in
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


def _lecun_normal(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: fan-in over every axis but the last."""
    from ..flashsr.prng import truncated_normal
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    return truncated_normal(key, shape) * np.float32(std)


def flax_init(module: nn.Module, key: np.ndarray) -> Dict[str, Any]:
    """``{"params": ...}``: what flax's ``init(key, ...)`` of ``module``'s
    counterpart draws.  Each scope numbers its ``make_rng`` calls from 1 in
    the order its parameters are created (a conv's or dense's kernel 1,
    bias 2; the quantizer's ``codebook_i`` i + 1), so a leaf's key depends
    on its path alone: lecun-normal kernels, zero biases, unit alphas and
    ``normal(1.0)`` codebooks."""
    from ..flashsr.prng import normal_from_key
    from ...utils.weights import flax_tree, sorted_leaves, unflatten

    flat = {}
    for path, spec in sorted_leaves(flax_tree(module)["params"]):
        *scope, leaf = path
        shape = tuple(spec.shape)
        if leaf == "bias":
            val = np.zeros(shape, np.float32)
        elif leaf == "alpha":
            val = np.ones(shape, np.float32)
        elif leaf.startswith("codebook_"):
            val = normal_from_key(_scope_key(key, tuple(scope), int(leaf[9:]) + 1), shape)
        else:
            val = _lecun_normal(_scope_key(key, tuple(scope), 1), shape)
        flat["/".join(path)] = val
    return {"params": unflatten(flat)}


def dac_params_from_jax(cfg: DACConfig, flax_params: Dict[str, Any]
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's DAC tree ``{"encoder": {"params": ...}, "decoder":
    ..., "rvq": ...}`` -> the port's state dicts, keyed the same: conv
    kernels ``[k, Ci, Co]`` -> ``[Co, Ci, k]``, transposed-conv kernels ->
    ``[Ci, Co, k]`` flipped along k, Dense ``[in, out]`` -> ``[out, in]``,
    Snake alphas and codebooks as they are."""
    from ...utils.weights import module_from_jax

    with torch.device("meta"):
        mods = DACModel(cfg)
    extra = set(flax_params) - {"encoder", "decoder", "rvq"}
    if extra:
        raise KeyError(f"dac_params_from_jax: unknown sub-models {sorted(extra)}")
    return {name: module_from_jax(getattr(mods, name), flax_params[name])
            for name in ("encoder", "decoder", "rvq")}


_CACHE: Dict[str, Tuple[DACModel, int]] = {}


def build_dac(model_type: str = "44khz", seed: int = 0) -> Tuple[DACModel, int]:
    """(model on the CPU, sample rate) per model type, cached: a converted
    checkpoint at ``weights_dir() / f"dac_{model_type}.npz"`` first
    ("converted"), then the trained codec at ``train.output_path``
    ("trained"), then the shipped compact codec ("shipped"), else seeded
    random weights with a warning ("random")."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown DAC model_type {model_type!r}")
    if model_type not in _CACHE:
        from ...utils.weights import load_params, weights_dir
        from .train import PRETRAINED, load_pretrained, served_path

        cfg = MODEL_TYPES[model_type]
        cache = weights_dir() / f"dac_{model_type}.npz"
        if cache.exists():                 # converted real checkpoint
            model = DACModel(cfg).load_jax(load_params(cache))
            model.weight_source = "converted"
        else:
            served = served_path(model_type)
            shipped = load_pretrained(model_type, served)
            if shipped is not None:        # the trained, else the in-repo, compact codec
                cfg, tree = shipped
                model = DACModel(cfg).load_jax(tree)
                model.weight_source = ("shipped" if served == PRETRAINED[model_type]
                                       else "trained")
            else:
                print(f"[egregora] WARNING: no DAC weights for {model_type!r} (no "
                      f"converted checkpoint at {cache} and no shipped distilled "
                      f"weights) — serving RANDOM-INIT params; encode/decode output "
                      f"will be garbage", flush=True)
                model = DACModel(cfg).init_params(seed)
        _CACHE[model_type] = (model.eval(), cfg.sample_rate)
    return _CACHE[model_type]


def dac_name_map(cfg: DACConfig = DACConfig()):
    """Upstream descript-audio-codec checkpoint naming -> the JAX
    package's tree (``utils.weights.convert_state_dict``'s ``name_map``).

    Upstream modules (dac/model/dac.py): ``encoder.block.{i}`` /
    ``decoder.model.{i}`` Sequentials of Snake1d and WNConv1d layers,
    ``quantizer.quantizers.{q}.{in_proj,out_proj,codebook}``; weight-norm
    pairs fold before this map; Snake1d alphas ``[1, C, 1]`` flatten and
    the RVQ's 1x1-conv projections ``[out, in, 1]`` become dense ``[in,
    out]``."""
    flat = lambda v: v.reshape(-1)                       # Snake alpha
    px = lambda v: v[:, :, 0].T                          # 1x1 conv -> dense
    m = {}

    def res_unit(t_prefix, f_prefix):
        m[f"{t_prefix}.block.0.alpha"] = (f"{f_prefix}/Snake_0/alpha", flat)
        m[f"{t_prefix}.block.1.weight"] = f"{f_prefix}/Conv_0/kernel"
        m[f"{t_prefix}.block.1.bias"] = f"{f_prefix}/Conv_0/bias"
        m[f"{t_prefix}.block.2.alpha"] = (f"{f_prefix}/Snake_1/alpha", flat)
        m[f"{t_prefix}.block.3.weight"] = f"{f_prefix}/Conv_1/kernel"
        m[f"{t_prefix}.block.3.bias"] = f"{f_prefix}/Conv_1/bias"

    n = len(cfg.strides)
    m["encoder.block.0.weight"] = "encoder/params/Conv_0/kernel"
    m["encoder.block.0.bias"] = "encoder/params/Conv_0/bias"
    for b in range(n):
        base_t = f"encoder.block.{b + 1}"
        base_f = f"encoder/params/EncoderBlock_{b}"
        for r in range(3):
            res_unit(f"{base_t}.block.{r}", f"{base_f}/ResidualUnit_{r}")
        m[f"{base_t}.block.3.alpha"] = (f"{base_f}/Snake_0/alpha", flat)
        m[f"{base_t}.block.4.weight"] = f"{base_f}/Conv_0/kernel"
        m[f"{base_t}.block.4.bias"] = f"{base_f}/Conv_0/bias"
    m[f"encoder.block.{n + 1}.alpha"] = ("encoder/params/Snake_0/alpha", flat)
    m[f"encoder.block.{n + 2}.weight"] = "encoder/params/Conv_1/kernel"
    m[f"encoder.block.{n + 2}.bias"] = "encoder/params/Conv_1/bias"

    m["decoder.model.0.weight"] = "decoder/params/Conv_0/kernel"
    m["decoder.model.0.bias"] = "decoder/params/Conv_0/bias"
    for b in range(n):
        base_t = f"decoder.model.{b + 1}"
        base_f = f"decoder/params/DecoderBlock_{b}"
        m[f"{base_t}.block.0.alpha"] = (f"{base_f}/Snake_0/alpha", flat)
        m[f"{base_t}.block.1.weight"] = (f"{base_f}/ConvTranspose_0/kernel",
                                         (2, 0, 1))     # torch [in, out, k]
        m[f"{base_t}.block.1.bias"] = f"{base_f}/ConvTranspose_0/bias"
        for r in range(3):
            res_unit(f"{base_t}.block.{r + 2}", f"{base_f}/ResidualUnit_{r}")
    m[f"decoder.model.{n + 1}.alpha"] = ("decoder/params/Snake_0/alpha", flat)
    m[f"decoder.model.{n + 2}.weight"] = "decoder/params/Conv_1/kernel"
    m[f"decoder.model.{n + 2}.bias"] = "decoder/params/Conv_1/bias"

    for q in range(cfg.n_codebooks):
        base = f"quantizer.quantizers.{q}"
        m[f"{base}.in_proj.weight"] = (f"rvq/params/proj_in_{q}/kernel", px)
        m[f"{base}.in_proj.bias"] = f"rvq/params/proj_in_{q}/bias"
        m[f"{base}.out_proj.weight"] = (f"rvq/params/proj_out_{q}/kernel", px)
        m[f"{base}.out_proj.bias"] = f"rvq/params/proj_out_{q}/bias"
        m[f"{base}.codebook.weight"] = f"rvq/params/codebook_{q}"
    return m.get
