"""Descript Audio Codec (DAC), inference: the port of
``egregora_tpu/models/dac/model.py``.

The same architecture on PyTorch's NCW layout:

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
returns that dtype.  Snake's alpha is a float32 parameter, so ``x +
sin^2(alpha x) / (alpha + 1e-9)`` is computed in float32, and the residual
adds keep the dtype the JAX package's promotion gives them.  Modules are
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


def snake(x: torch.Tensor, alpha: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """``x + sin^2(alpha x) / (alpha + 1e-9)`` over ``[B, C, T]`` in float32,
    alpha clamped from below at ``floor`` where it is positive."""
    a = (alpha.clamp_min(floor) if floor > 0.0 else alpha).float()[:, None]
    x = x.float()
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


class Snake(nn.Module):
    def __init__(self, channels: int, floor: float = 0.0):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))
        self.floor = floor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha, self.floor)


class ResidualUnit(nn.Module):
    def __init__(self, channels: int, dilation: int, cfg: DACConfig):
        super().__init__()
        self.Snake_0 = Snake(channels, cfg.alpha_floor)
        self.Conv_0 = Conv1d(channels, channels, 7, dilation, cfg.dtype)
        self.Snake_1 = Snake(channels, cfg.alpha_floor)
        self.Conv_1 = Conv1d(channels, channels, 1, 1, cfg.dtype)
        self.res_scale = cfg.res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_1(self.Snake_1(self.Conv_0(self.Snake_0(x))))
        return x + self.res_scale * h


class EncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, cfg: DACConfig):
        super().__init__()
        for i, d in enumerate((1, 3, 9)):
            self.add_module(f"ResidualUnit_{i}", ResidualUnit(cin, d, cfg))
        self.Snake_0 = Snake(cin, cfg.alpha_floor)
        self.Conv_0 = Conv1d(cin, cout, 2 * stride, 1, cfg.dtype, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"ResidualUnit_{i}")(x)
        return self.Conv_0(self.Snake_0(x))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, cfg: DACConfig):
        super().__init__()
        self.Snake_0 = Snake(cin, cfg.alpha_floor)
        self.ConvTranspose_0 = ConvTranspose1d(cin, cout, 2 * stride, stride, cfg.dtype)
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
        self.Conv_0 = Conv1d(1, c.encoder_dim, 7, 1, c.dtype)
        ch = c.encoder_dim
        for i, s in enumerate(c.strides):
            self.add_module(f"EncoderBlock_{i}", EncoderBlock(ch, 2 * ch, s, c))
            ch *= 2
        self.Snake_0 = Snake(ch, c.alpha_floor)
        self.Conv_1 = Conv1d(ch, c.latent_dim, 3, 1, c.dtype)
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
        self.Conv_0 = Conv1d(c.latent_dim, c.decoder_dim, 7, 1, c.dtype)
        ch = c.decoder_dim
        for i, s in enumerate(reversed(c.strides)):
            self.add_module(f"DecoderBlock_{i}", DecoderBlock(ch, ch // 2, s, c))
            ch //= 2
        self.Snake_0 = Snake(ch, c.alpha_floor)
        self.Conv_1 = Conv1d(ch, 1, 7, 1, c.dtype)
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
            z = self.encoder(x[:, None]).transpose(1, 2)
            return self.rvq(z)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """``[C, T/hop, D] -> [C, T]`` float32, on the model's device."""
        with exact_f32():
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
