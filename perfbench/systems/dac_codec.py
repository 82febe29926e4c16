"""The DAC codec nodes as a system under test: a song encoded to codes by
``Egregora_DAC_Encode`` and decoded back by ``Egregora_DAC_Decode``.

**The system.** ``build`` makes the configuration's codec the way a
converted upstream checkpoint would be served, without a file: the
benchmark's seeded upstream state dict (``upstream_state_dict``: the
layout of ``reference.dac.upstream_layout``, drawn from the weight seed
and ``--seed``) folded and converted by the port's own
``utils.weights.convert_state_dict`` and ``dac_name_map``, loaded by
``DACModel.load_jax``, placed on the device and put in the encode node's
class cache (``Egregora_DAC_Encode._MODELS[model_type]``), which the
decode node reads too; ``weight_source`` "converted".  ``Codec.call``
calls the two nodes as a ComfyUI graph does: ``Egregora_DAC_Encode().
execute(audio, model_type)``, then ``Egregora_DAC_Decode().execute(codes)``
on the returned dict, and returns the codes dict's codes and latents and
the decoded AUDIO's waveform, all on the host.  A call's units of work
are codec frames: ``ceil(T / hop)`` of the input at the codec's rate,
times channels.

**The draw** (``assumed`` in the configuration): weight-norm pairs with
``weight_v`` of unit spread and ``weight_g`` that gives the folded weight
the lecun scale (std ``fan_in ** -0.5``; a transposed conv's fan-in is
``C_in * k / s``, the inputs each output sums), except each residual
unit's 1x1 conv at 0.3 of it and the decoder's output conv at 0.1 of it,
which keep the stacked units and the tanh out of saturation (as
``chip_smoke.seeded_dac_tree`` does); biases 0.02 N(0, 1); Snake alphas
U(0.5, 1.5); codebooks N(0, 1), upstream's ``nn.Embedding`` init.

**Spans** (traced runs only): ``pb.dac.call`` around each call, from the
benchmark's side; the rest are the program's own (``utils/profiling.py``),
named here so that the trace reduces by them: ``egr.node.dac_encode``,
``egr.node.dac_decode``, ``egr.dac.encoder``, ``egr.dac.rvq``,
``egr.dac.decoder`` and ``egr.dac.snake`` (each Snake).  A program
without them leaves those spans empty, and their readers find nothing.

**Faults**, planted under the timed path on the served model's instances
(the program's files are untouched) and taken out by ``undo``:

* ``one_channel``: the encoder's first channel served for both: the codes
  and latents of channel 0 handed out for every channel;
* ``stage_dropped``: the quantizer's last stage left out of the latents
  it hands out (its codes kept);
* ``last_block_bare``: the decoder's last block skips its three residual
  units (transposed conv only).

**The check.** The sample is run again through the plain float32
reference (``perfbench/reference/dac.py``) from the same upstream state
dict, and held against each served output by three numbers, each pooled
over the sample by ``harness.check`` (summed squared gap over summed
squared reference):

* ``wave_rel_l2``: the served audio against the reference's float32
  decode of the served latents: the decoder alone, whatever codes flipped;
* ``latent_rel_l2``: the served latents against ``sum_q proj_out_q(
  codebook_q[served code])``, rebuilt by the reference: ties the latents
  the decode node reads to the codes the encode node hands out;
* ``code_excess``: the reference's float32 encoder output walked stage by
  stage along the served codes (``ReferenceDAC.walk``); each stage adds
  ``|r - c_served|^2 - min_k |r - c_k|^2``, over the walk's own
  quantisation error ``min_k |r - c_k|^2``.  Codes are not compared one by
  one: bfloat16 rounding tips the argmin where two codes lie nearly as
  close, and such a flip costs almost nothing here, while a wrong encoder
  or lookup costs as much as the quantisation error itself.

The control (``mode`` "control"), which has to come out as not correct,
is the reference with every conv's operands in fp8 (e4m3, one scale a
tensor, float32 accumulation) and the float32 parts (the quantizer) in
TF32, run as a codec end to end.  An output that is not finite, or of
another shape than the reference's, is not correct whatever the numbers.
Each sampled file also prints to standard error the share of its output
samples with ``|y| > 0.99`` (the tanh's saturation) and the distinct codes
each quantizer stage used, so that a vacuous check shows.
"""
from __future__ import annotations

import functools
import math
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness.traffic import Item
from perfbench.harness.weights import draw_seed
from perfbench.reference import dac
from perfbench.reference.numerics import float32_mode, precision

NUMBERS = ("wave_rel_l2", "latent_rel_l2", "code_excess")
UNIT_GAIN, OUTPUT_GAIN = 0.3, 0.1


# ---- the seeded upstream checkpoint ----

def _gain(key: str, g: Dict) -> float:
    """The extra scale of a weight-norm pair's folded weight."""
    parts = key.split(".")
    if key.startswith(f"decoder.model.{len(g['strides']) + 2}."):
        return OUTPUT_GAIN
    if len(parts) == 8 and parts[-3:-1] == ["block", "3"]:    # a residual unit's 1x1 conv
        return UNIT_GAIN
    return 1.0


def upstream_state_dict(g: Dict, weight_seed: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The upstream checkpoint's state dict for geometry ``g``: float32
    tensors on ``device``, drawn from one generator in one call and cut
    in the layout's order, the same for the same seeds on every run."""
    lay = dac.upstream_layout(g)
    total = sum(math.prod(shape) for shape, _, _ in lay.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(weight_seed, seed))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for key, (shape, role, fan_in) in lay.items():
        n = math.prod(shape)
        z = buf[at: at + n].view(shape)
        at += n
        if role == "weight_g":
            per_row = math.prod(lay[key[:-1] + "v"][0][1:])
            t = (1.0 + 0.1 * z).abs() * math.sqrt(per_row / fan_in) * _gain(key, g)
        elif role == "alpha":
            t = 0.5 + torch.special.ndtr(z)
        elif role == "bias":
            t = 0.02 * z
        else:                                           # weight_v, codebook
            t = z
        out[key] = t
    return out


# ---- the system ----

def port_config(config: Dict):
    """The port's ``DACConfig`` for the configuration."""
    from egregora_tpu_torch.models.dac.model import DACConfig
    g = dict(config["geometry"])
    g["strides"] = tuple(g["strides"])
    return DACConfig(dtype=getattr(torch, config["dtype"]), **g)


def build(config: Dict, root, seed: int, device: str = "cuda") -> "Codec":
    """The configuration's codec in the encode node's class cache, and the
    two nodes to call."""
    from egregora_tpu_torch.models.dac.model import DACModel, dac_name_map
    from egregora_tpu_torch.nodes.enhance_extras import Egregora_DAC_Decode, Egregora_DAC_Encode
    from egregora_tpu_torch.utils.weights import convert_state_dict, flax_tree

    w = config["weights"]
    if w["kind"] != "upstream_seeded":
        raise ValueError(f"unknown weights kind {w['kind']!r}")
    cfg = port_config(config)
    sd = upstream_state_dict(config["geometry"], w["weight_seed"], seed, device)
    host = {k: t.cpu().numpy() for k, t in sd.items()}
    del sd
    with torch.device("meta"):
        meta = DACModel(cfg)
    target = {n: flax_tree(getattr(meta, n)) for n in ("encoder", "decoder", "rvq")}
    tree = convert_state_dict(host, target, name_map=dac_name_map(cfg))
    model = DACModel(cfg).load_jax(tree).eval().to(device)
    model.weight_source = "converted"
    model_type = config["model_type"]
    Egregora_DAC_Encode.DEVICE = Egregora_DAC_Decode.DEVICE = device
    Egregora_DAC_Encode._MODELS[model_type] = (model, cfg.sample_rate)
    return Codec(model, model_type, cfg.sample_rate, cfg.hop, Egregora_DAC_Encode(),
                 Egregora_DAC_Decode())


def release() -> None:
    """Drop the codecs the encode node caches and the device memory they held."""
    import gc

    from egregora_tpu_torch.nodes.enhance_extras import Egregora_DAC_Encode
    Egregora_DAC_Encode._MODELS.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Codec:
    """The two nodes and the codec in the encode node's class cache."""

    FAULTS = ("one_channel", "stage_dropped", "last_block_bare")

    def __init__(self, model, model_type: str, sample_rate: int, hop: int, enc, dec):
        self.model, self.model_type = model, model_type
        self.sample_rate, self.hop = sample_rate, hop
        self.enc, self.dec = enc, dec
        self._planted: List[Tuple[object, str]] = []

    @property
    def weight_source(self) -> str:
        return self.model.weight_source

    def call(self, item: Item) -> Dict[str, np.ndarray]:
        """The codes dict's ``codes`` ``[C, n_q, F]`` and ``latents`` ``[C,
        F, D]``, and the decoded waveform ``[C, F * hop]``."""
        codes, _ = self.enc.execute(item.audio(), self.model_type)
        audio, _ = self.dec.execute(codes)
        return {"codes": np.asarray(codes["codes"]), "latents": np.asarray(codes["latents"][0][0]),
                "audio": audio["waveform"][0].numpy()}

    def rows(self, item: Item) -> int:
        """Codec frames of one call: frames of the input at the codec's
        rate, times channels."""
        n, sr = item.samples.shape[-1], item.sr
        if sr != self.sample_rate:
            g = math.gcd(sr, self.sample_rate)
            n = -(-n * (self.sample_rate // g) // (sr // g))
        return -(-n // self.hop) * item.samples.shape[0]

    def spans(self) -> "Spans":
        return Spans(self)

    def plant(self, name: str) -> None:
        owner, attr, make = _PLANT[name](self.model)
        setattr(owner, attr, make(getattr(owner, attr)))
        self._planted.append((owner, attr))

    def undo(self) -> None:
        for owner, attr in self._planted:
            vars(owner).pop(attr, None)
        self._planted.clear()


# ---- spans ----

class Spans:
    """The traced run's spans: ``pb.dac.call`` around each call, and the
    program's own spans by name."""

    # outermost first: the innermost enclosing span names an idle gap
    NAMES = ("pb.dac.call", "egr.node.dac_encode", "egr.node.dac_decode", "egr.dac.encoder",
             "egr.dac.rvq", "egr.dac.decoder", "egr.dac.snake")

    def __init__(self, served: Codec):
        self.served, self.attn_calls = served, []

    def install(self) -> "Spans":
        call = self.served.call

        @functools.wraps(call)
        def spanned(item):
            with record_function("pb.dac.call"):
                return call(item)
        self.served.call = spanned
        return self

    def uninstall(self) -> None:
        vars(self.served).pop("call", None)


# ---- faults ----

def _one_channel(model) -> Tuple[object, str, Callable]:
    def make(encode):
        def one(x_ct):
            z, codes = encode(x_ct)
            return z[:1].expand_as(z).contiguous(), codes[:1].expand_as(codes).contiguous()
        return one
    return model, "encode", make


def _stage_dropped(model) -> Tuple[object, str, Callable]:
    rvq = model.rvq
    last = rvq.n_codebooks - 1

    def make(forward):
        def dropped(z, *args, **kwargs):
            z_q, codes = forward(z, *args, **kwargs)[:2]
            book = getattr(rvq, f"codebook_{last}")
            return z_q - getattr(rvq, f"proj_out_{last}")(book[codes[:, last]]), codes
        return dropped
    return rvq, "forward", make


def _last_block_bare(model) -> Tuple[object, str, Callable]:
    block = getattr(model.decoder, f"DecoderBlock_{model.decoder.n_blocks - 1}")

    def make(forward):
        def bare(x):
            return block.ConvTranspose_0(block.Snake_0(x))
        return bare
    return block, "forward", make


_PLANT: Dict[str, Callable] = {"one_channel": _one_channel, "stage_dropped": _stage_dropped,
                               "last_block_bare": _last_block_bare}


# ---- the check ----

class Reference:
    """What ``sums`` needs of the reference for one file: the codec and its
    float32 encoder output ``[C, F, D]`` of the file."""

    def __init__(self, codec: dac.ReferenceDAC, latents: List[torch.Tensor]):
        self.codec, self.latents = codec, latents


def reference_outputs(config: Dict, root, seed: int, items: List[Item], device,
                      mode: str = "fp32") -> List[Tuple[object, Reference]]:
    """For each item, ``(output, Reference)``: in "control" the control's
    codec output in the form ``call`` returns; in "fp32" no output (``sums``
    decodes the served latents itself) and the float32 encoder output."""
    g = config["geometry"]
    sd = upstream_state_dict(g, config["weights"]["weight_seed"], seed, device)
    ref = dac.ReferenceDAC(g, dac.load_upstream(g, sd, device), device)
    sr = int(g["sample_rate"])
    out = []
    for item in items:
        if item.sr != sr:
            raise ValueError(f"the DAC reference takes audio at {sr} Hz, not {item.sr}")
        x = ref.preprocess(torch.from_numpy(item.samples).float())
        if mode == "control":
            with precision("fp8"), float32_mode(tf32=True):
                got = ref.codec(x)
            out.append(({k: v.numpy() for k, v in got.items()}, None))
        elif mode == "fp32":
            with float32_mode(tf32=False):
                out.append((None, Reference(ref, [ref.encoder(x[c]) for c in range(x.shape[0])])))
        else:
            raise ValueError(f"reference mode: expected fp32 or control, got {mode!r}")
    return out


def _sum2(x: torch.Tensor) -> float:
    return float(x.double().square().sum())


def sums(output: Dict[str, np.ndarray], reference: Tuple[object, Reference],
         device) -> Dict[str, float]:
    """One file's squared gaps and squared reference for each number
    (``nan`` where the output is unusable)."""
    ref = reference[1]
    codec = ref.codec
    keys = [f"{n}_{part}" for n in NUMBERS for part in ("gap2", "ref2")]
    c, f, d = len(ref.latents), ref.latents[0].shape[0], ref.latents[0].shape[1]
    shapes = {"codes": (c, int(codec.g["n_codebooks"]), f), "latents": (c, f, d),
              "audio": (c, f * dac.hop(codec.g))}
    if any(tuple(np.shape(output[k])) != s for k, s in shapes.items()) or \
            not all(np.all(np.isfinite(output[k])) for k in ("latents", "audio")):
        return {k: float("nan") for k in keys}
    res = dict.fromkeys(keys, 0.0)
    saturated, distinct = 0, []
    with float32_mode(tf32=False):
        for ch in range(c):
            codes = torch.from_numpy(np.ascontiguousarray(output["codes"][ch])).to(device)
            lat = torch.from_numpy(np.ascontiguousarray(output["latents"][ch])).to(device)
            rebuilt = codec.rebuild(codes)
            res["latent_rel_l2_gap2"] += _sum2(lat - rebuilt)
            res["latent_rel_l2_ref2"] += _sum2(rebuilt)
            del rebuilt
            y = torch.from_numpy(np.ascontiguousarray(output["audio"][ch])).to(device)
            y_ref = codec.decoder(lat)
            res["wave_rel_l2_gap2"] += _sum2(y - y_ref)
            res["wave_rel_l2_ref2"] += _sum2(y_ref)
            saturated += int((y.abs() > 0.99).sum())
            del y, y_ref
            excess, qerr = codec.walk(ref.latents[ch], codes)
            res["code_excess_gap2"] += excess
            res["code_excess_ref2"] += qerr
            distinct.append([int(torch.unique(k).numel()) for k in codes])
    print(f"dac_codec: sampled file of {f} frames x {c} channels: |y| > 0.99 on "
          f"{saturated / (c * f * dac.hop(codec.g)):.3e} of the samples; distinct codes a "
          f"stage, per channel {distinct}", file=sys.stderr)
    return res
