"""A plain float32 Descript Audio Codec (DAC) in PyTorch: the reference
of the ``dac_codec`` system.

A frozen copy of what the port's DAC (``models/dac/model.py`` on the
layers of ``models/flashsr/layers.py``) computes, with every compute
dtype taken out: float32 throughout, TF32 off (``numerics.float32_mode``),
and each product's operands through ``numerics.operand`` (float32, or the
fp8 control).  It imports nothing of the port or of JAX, and converts the
upstream checkpoint layout itself (``load_upstream``).

The model (arXiv:2306.06546; github.com/descriptinc/descript-audio-codec):

* encoder: a 7-tap conv stem, then per stride s a block of three residual
  units (Snake, a 7-tap conv dilated 1 / 3 / 9, Snake, a 1-tap conv, added
  to the unit's input), a Snake and a conv of kernel 2s and stride s that
  doubles the channels; a Snake and a 3-tap conv to the latent;
* residual vector quantizer: per stage the residual projected to the
  codebook dimension, the nearest code by squared distance, projected
  back and subtracted from the residual;
* decoder: a 7-tap conv stem, then per stride (reversed) a Snake, a
  transposed conv of kernel 2s and stride s that halves the channels and
  three residual units; a Snake, a 7-tap conv to one channel, a tanh.

Snake is ``x + sin^2(alpha x) / (alpha + 1e-9)``.

Departures from the published model, all of them the port's (and the JAX
package's):

* the quantizer looks up the nearest code by squared distance between the
  unnormalised projection and the unnormalised codes; upstream
  L2-normalises both before the lookup;
* padding alignment: every conv pads as flax's 'SAME' does (the odd pad
  after the signal); the transposed convs follow flax's ``ConvTranspose``
  ('SAME', ``transpose_kernel=False``): the zero-stuffed input correlated
  with the upstream kernel as stored, which is ``conv_transpose1d`` with
  the kernel flipped along its taps, cropped to ``length * stride``
  samples from flax's offset; upstream's ``ConvTranspose1d`` pads
  ``ceil(s / 2)`` on both sides and does not flip;
* weight norm folded: each ``weight_g * weight_v / ||weight_v||`` (norm
  over all dims but 0) is folded into one weight at load, and the
  quantizer's 1x1-conv projections are dense layers.

The codec runs one channel at a time, so that the pool's longest song
(300 s, 13.2M samples a channel) fits on the card in float32: the
decoder's last stage holds ``[1, 96, 13.2M]`` float32 tensors, 5.1 GB
each.  ``walk`` holds a quantizer's choices against this reference's own
latents (``dac_codec.code_excess``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import operand

DILATIONS = (1, 3, 9)
Layout = Dict[str, Tuple[Tuple[int, ...], str, float]]     # key -> (shape, role, fan-in)


def latent_dim(g: Dict) -> int:
    return int(g["encoder_dim"]) * 2 ** len(g["strides"])


def hop(g: Dict) -> int:
    return math.prod(int(s) for s in g["strides"])


def _channels(g: Dict) -> Tuple[List[int], List[int]]:
    """The encoder's block input widths and the decoder's."""
    enc = [int(g["encoder_dim"]) * 2 ** i for i in range(len(g["strides"]))]
    dec = [int(g["decoder_dim"]) // 2 ** i for i in range(len(g["strides"]))]
    return enc, dec


# ---- the upstream layout and its conversion ----

def upstream_layout(g: Dict) -> Layout:
    """Each key of the upstream checkpoint's state dict, in its order, with
    its shape, its role (``weight_v``, ``weight_g``, ``bias``, ``alpha``,
    ``codebook``) and the fan-in of the weight it belongs to (the inputs
    that each output sums: ``C_in * k`` for a conv, ``C_in * k / s`` for a
    transposed conv of stride s)."""
    lay: Layout = {}

    def wn(prefix: str, shape: Tuple[int, ...], fan_in: float, bias: int) -> None:
        lay[f"{prefix}.weight_g"] = ((shape[0], 1, 1), "weight_g", fan_in)
        lay[f"{prefix}.weight_v"] = (shape, "weight_v", fan_in)
        lay[f"{prefix}.bias"] = ((bias,), "bias", fan_in)

    def snake(prefix: str, c: int) -> None:
        lay[f"{prefix}.alpha"] = ((1, c, 1), "alpha", 1.0)

    def unit(prefix: str, c: int) -> None:
        snake(f"{prefix}.block.0", c)
        wn(f"{prefix}.block.1", (c, c, 7), 7 * c, c)
        snake(f"{prefix}.block.2", c)
        wn(f"{prefix}.block.3", (c, c, 1), c, c)

    enc, dec = _channels(g)
    strides = [int(s) for s in g["strides"]]
    n, d = len(strides), latent_dim(g)
    wn("encoder.block.0", (enc[0], 1, 7), 7, enc[0])
    for b, (c, s) in enumerate(zip(enc, strides)):
        for r in range(3):
            unit(f"encoder.block.{b + 1}.block.{r}", c)
        snake(f"encoder.block.{b + 1}.block.3", c)
        wn(f"encoder.block.{b + 1}.block.4", (2 * c, c, 2 * s), 2 * s * c, 2 * c)
    snake(f"encoder.block.{n + 1}", 2 * enc[-1])
    wn(f"encoder.block.{n + 2}", (d, 2 * enc[-1], 3), 3 * 2 * enc[-1], d)
    for q in range(int(g["n_codebooks"])):
        base = f"quantizer.quantizers.{q}"
        cd = int(g["codebook_dim"])
        wn(f"{base}.in_proj", (cd, d, 1), d, cd)
        wn(f"{base}.out_proj", (d, cd, 1), cd, d)
        lay[f"{base}.codebook.weight"] = ((int(g["codebook_size"]), cd), "codebook", 1.0)
    wn("decoder.model.0", (dec[0], d, 7), 7 * d, dec[0])
    for b, (c, s) in enumerate(zip(dec, reversed(strides))):
        snake(f"decoder.model.{b + 1}.block.0", c)
        # ConvTranspose1d weight [in, out, k]; weight norm over dim 0 (per input channel)
        lay[f"decoder.model.{b + 1}.block.1.weight_g"] = ((c, 1, 1), "weight_g", 2 * c)
        lay[f"decoder.model.{b + 1}.block.1.weight_v"] = ((c, c // 2, 2 * s), "weight_v", 2 * c)
        lay[f"decoder.model.{b + 1}.block.1.bias"] = ((c // 2,), "bias", 2 * c)
        for r in range(3):
            unit(f"decoder.model.{b + 1}.block.{r + 2}", c // 2)
    snake(f"decoder.model.{n + 1}", dec[-1] // 2)
    wn(f"decoder.model.{n + 2}", (1, dec[-1] // 2, 7), 7 * dec[-1] // 2, 1)
    return lay


def fold(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Weight-norm pairs folded: ``g * v / ||v||`` over all dims but 0."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[: -len("_v")]
            v = v.float()
            norm = v.flatten(1).norm(dim=1).reshape((-1,) + (1,) * (v.dim() - 1))
            out[base] = sd[base + "_g"].float() * v / norm
        else:
            out[k] = v.float()
    return out


class Params:
    """The codec's weights in the layouts the reference computes with:
    conv weights ``[out, in, k]`` as upstream stores them, transposed-conv
    weights ``[in, out, k]`` flipped along k, projections ``[out, in]``,
    alphas ``[C]``, codebooks ``[K, d]``."""

    def __init__(self, g: Dict, sd: Dict[str, torch.Tensor]):
        self.g, self.w = g, fold(sd)
        for b in range(len(g["strides"])):
            key = f"decoder.model.{b + 1}.block.1.weight"
            self.w[key] = self.w[key].flip(-1)

    def conv(self, prefix: str) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.w[prefix + ".weight"], self.w[prefix + ".bias"]

    def alpha(self, prefix: str) -> torch.Tensor:
        return self.w[prefix + ".alpha"].reshape(-1)

    def proj(self, q: int, which: str) -> Tuple[torch.Tensor, torch.Tensor]:
        w, b = self.w[f"quantizer.quantizers.{q}.{which}.weight"], \
            self.w[f"quantizer.quantizers.{q}.{which}.bias"]
        return w[:, :, 0], b

    def codebook(self, q: int) -> torch.Tensor:
        return self.w[f"quantizer.quantizers.{q}.codebook.weight"]


def load_upstream(g: Dict, sd: Dict[str, torch.Tensor], device) -> Params:
    """The upstream state dict (weight-norm pairs, alphas ``[1, C, 1]``,
    1x1-conv projections, codebooks) as the reference's weights on
    ``device``; every key of ``upstream_layout`` is needed."""
    lay = upstream_layout(g)
    missing = sorted(set(lay) - set(sd))
    if missing:
        raise KeyError(f"upstream DAC state dict lacks {missing[:8]}")
    return Params(g, {k: sd[k].to(device) for k in lay})


# ---- the arithmetic ----

def same_pads(size: int, k: int, stride: int = 1, dilation: int = 1) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding ``(before, after)``."""
    out = -(-size // stride)
    need = max(0, (out - 1) * stride + (k - 1) * dilation + 1 - size)
    return need // 2, need - need // 2


def conv(x: torch.Tensor, wb, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    w, b = wb
    lo, hi = same_pads(x.shape[-1], w.shape[-1], stride, dilation)
    return F.conv1d(F.pad(operand(x), (lo, hi)), operand(w), b, stride, 0, dilation)


def conv_transpose(x: torch.Tensor, wb, stride: int) -> torch.Tensor:
    """flax ``ConvTranspose`` ('SAME', ``transpose_kernel=False``) with the
    flipped kernel ``[in, out, k]``: ``[B, Ci, T] -> [B, Co, T * stride]``."""
    w, b = wb
    k, t = w.shape[-1], x.shape[-1]
    y = F.conv_transpose1d(operand(x), operand(w), stride=stride)
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    p, n = k - 1 - pad_a, t * stride
    lo, hi = max(p, 0), min(p + n, y.shape[-1])
    y = F.pad(y[..., lo:hi], (lo - p, p + n - hi))
    return y + b[:, None]


def snake(x: torch.Tensor, alpha: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """``x + sin^2(alpha x) / (alpha + 1e-9)`` over ``[B, C, T]``, alpha
    clamped from below at ``floor`` where that is positive; the
    temporaries are taken in place (one beside ``x``)."""
    a = (alpha.clamp_min(floor) if floor > 0.0 else alpha).float()[:, None]
    t = a * x
    t.sin_().square_().div_(a + 1e-9)
    return t.add_(x)


class ReferenceDAC:
    """The codec of geometry ``g`` on ``device`` with weights ``p``."""

    def __init__(self, g: Dict, p: Params, device):
        self.g, self.p, self.device = g, p, device
        self.floor = float(g.get("alpha_floor", 0.0))
        self.res_scale = float(g.get("res_scale", 1.0))

    def _unit(self, x: torch.Tensor, prefix: str, dilation: int) -> torch.Tensor:
        p, f = self.p, self.floor
        h = conv(snake(x, p.alpha(f"{prefix}.block.0"), f), p.conv(f"{prefix}.block.1"),
                 dilation=dilation)
        h = conv(snake(h, p.alpha(f"{prefix}.block.2"), f), p.conv(f"{prefix}.block.3"))
        return x + self.res_scale * h

    @torch.no_grad()
    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        """``[T]`` (a hop multiple) -> ``[T / hop, latent_dim]`` float32."""
        p, f = self.p, self.floor
        strides = [int(s) for s in self.g["strides"]]
        h = conv(x.float().to(self.device)[None, None], p.conv("encoder.block.0"))
        for b, s in enumerate(strides):
            pre = f"encoder.block.{b + 1}"
            for r, d in enumerate(DILATIONS):
                h = self._unit(h, f"{pre}.block.{r}", d)
            h = conv(snake(h, p.alpha(f"{pre}.block.3"), f), p.conv(f"{pre}.block.4"), stride=s)
        n = len(strides)
        h = conv(snake(h, p.alpha(f"encoder.block.{n + 1}"), f), p.conv(f"encoder.block.{n + 2}"))
        return h[0].t().contiguous()

    @torch.no_grad()
    def decoder(self, z: torch.Tensor) -> torch.Tensor:
        """``[T / hop, latent_dim] -> [T]`` float32."""
        p, f = self.p, self.floor
        strides = [int(s) for s in self.g["strides"]][::-1]
        h = conv(z.float().to(self.device).t()[None], p.conv("decoder.model.0"))
        for b, s in enumerate(strides):
            pre = f"decoder.model.{b + 1}"
            h = conv_transpose(snake(h, p.alpha(f"{pre}.block.0"), f), p.conv(f"{pre}.block.1"), s)
            for r, d in enumerate(DILATIONS):
                h = self._unit(h, f"{pre}.block.{r + 2}", d)
        n = len(strides)
        h = conv(snake(h, p.alpha(f"decoder.model.{n + 1}"), f), p.conv(f"decoder.model.{n + 2}"))
        h = h[0, 0]
        return torch.tanh(h) if self.g.get("output_tanh", True) else h

    def _proj(self, x: torch.Tensor, q: int, which: str) -> torch.Tensor:
        """A quantizer projection: float32, as the port computes it (TF32
        in the control, never fp8)."""
        w, b = self.p.proj(q, which)
        return F.linear(x.float(), w, b)

    @torch.no_grad()
    def quantize(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[F, D] -> (z_q [F, D], codes [n_q, F])`` as the port's
        quantizer picks them: per stage ``|r|^2 - 2 r.c + |c|^2``, argmin."""
        residual, z_q, codes = z, torch.zeros_like(z), []
        for q in range(int(self.g["n_codebooks"])):
            book = self.p.codebook(q)
            r = self._proj(residual, q, "in_proj")
            d2 = (r.square().sum(-1, keepdim=True) - (2.0 * r) @ book.T
                  + book.square().sum(-1))
            idx = d2.argmin(-1)
            out = self._proj(book[idx], q, "out_proj")
            z_q, residual = z_q + out, residual - out
            codes.append(idx)
        return z_q, torch.stack(codes)

    @torch.no_grad()
    def rebuild(self, codes: torch.Tensor) -> torch.Tensor:
        """``codes [n_q, F] -> sum_q proj_out_q(codebook_q[codes_q])`` ``[F, D]``."""
        codes = codes.to(self.device).long()
        z_q = None
        for q in range(codes.shape[0]):
            out = self._proj(self.p.codebook(q)[codes[q]], q, "out_proj")
            z_q = out if z_q is None else z_q + out
        return z_q

    @torch.no_grad()
    def walk(self, z: torch.Tensor, codes: torch.Tensor, block: int = 4096
             ) -> Tuple[float, float]:
        """The quantizer walked along ``codes [n_q, F]`` from the latents
        ``z [F, D]``, in float64: ``(sum over stages and frames of |r -
        c_served|^2 - min_k |r - c_k|^2, sum of min_k |r - c_k|^2)``, each
        stage's ``r`` projected from the residual that the served codes of
        the stages before it leave."""
        codes = codes.to(self.device).long()
        residual = z.double().to(self.device)
        excess = qerr = 0.0
        for q in range(codes.shape[0]):
            book = self.p.codebook(q).double()
            w_in, b_in = (t.double() for t in self.p.proj(q, "in_proj"))
            w_out, b_out = (t.double() for t in self.p.proj(q, "out_proj"))
            r = F.linear(residual, w_in, b_in)
            for i in range(0, r.shape[0], block):
                d2 = (r[i:i + block, None, :] - book[None]).square().sum(-1)
                best = d2.min(-1).values
                got = d2.gather(1, codes[q, i:i + block, None])[:, 0]
                excess += float((got - best).sum())
                qerr += float(best.sum())
            residual = residual - F.linear(book[codes[q]], w_out, b_out)
        return excess, qerr

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """Right-pad ``[..., T]`` to a hop multiple."""
        return F.pad(x, (0, (-x.shape[-1]) % hop(self.g)))

    @torch.no_grad()
    def codec(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The codes dict's content and the decoded audio for ``[C, T]``
        at the codec's rate, channel by channel, on the host:
        ``{"codes" [C, n_q, F] int32, "latents" [C, F, D], "audio" [C, F * hop]}``."""
        x = self.preprocess(torch.as_tensor(x).float())
        codes, lat, audio = [], [], []
        for c in range(x.shape[0]):
            z_q, k = self.quantize(self.encoder(x[c]))
            audio.append(self.decoder(z_q).cpu())
            codes.append(k.int().cpu())
            lat.append(z_q.cpu())
        return {"codes": torch.stack(codes), "latents": torch.stack(lat),
                "audio": torch.stack(audio)}


def parameter_count(g: Dict) -> int:
    """Parameters of the folded codec (a weight-norm pair counts as its weight)."""
    return sum(math.prod(shape) for shape, role, _ in upstream_layout(g).values()
               if role != "weight_g")


def snake_shapes(g: Dict, frames: int) -> List[Tuple[int, int]]:
    """``(channels, samples)`` of each Snake the codec runs on one channel
    of ``frames`` codec frames, encoder then decoder (a residual unit's two
    and each block's one)."""
    enc, dec = _channels(g)
    strides = [int(s) for s in g["strides"]]
    out: List[Tuple[int, int]] = []
    t = frames * hop(g)
    for c, s in zip(enc, strides):
        out += [(c, t)] * 7
        t //= s
    out.append((2 * enc[-1], t))
    for c, s in zip(dec, reversed(strides)):
        out.append((c, t))
        t *= s
        out += [(c // 2, t)] * 6
    out.append((dec[-1] // 2, t))
    return out


def flops_per_frame(g: Dict) -> float:
    """Operations of the codec on one codec frame of one channel (two a
    multiply-add): every conv and transposed conv, and per quantizer
    stage the two projections and the distance product.  Element-wise
    work is not counted."""
    enc, dec = _channels(g)
    strides = [int(s) for s in g["strides"]]
    d, cd, k = latent_dim(g), int(g["codebook_dim"]), int(g["codebook_size"])
    t = hop(g)
    ops = 2.0 * 7 * enc[0] * t
    for c, s in zip(enc, strides):
        ops += 3 * 2.0 * (7 + 1) * c * c * t            # three residual units
        t //= s
        ops += 2.0 * 2 * s * c * 2 * c * t              # the strided conv
    ops += 2.0 * 3 * 2 * enc[-1] * d * t
    ops += int(g["n_codebooks"]) * 2.0 * (d * cd + cd * k + cd * d)
    ops += 2.0 * 7 * d * dec[0] * t
    for c, s in zip(dec, reversed(strides)):
        ops += 2.0 * 2 * s * c * (c // 2) * t           # the transposed conv, per input frame
        t *= s
        ops += 3 * 2.0 * (7 + 1) * (c // 2) ** 2 * t
    ops += 2.0 * 7 * (dec[-1] // 2) * t
    return ops

