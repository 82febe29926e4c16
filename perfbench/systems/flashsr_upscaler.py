"""The FlashSR upscaler node as a system under test.

**The system.** ``build`` makes the cell's ``FlashSRPipeline`` the way
the node's resolver would serve it, without the resolver's file lookups:

* ``upstream_seeded``: the benchmark's seeded upstream state dicts
  (``harness.weights.upstream_state_dicts``), converted by the port's own
  name maps and ``convert_state_dict`` (the body of
  ``distill.convert_flashsr_trio``, less its write of a cache file) and
  ``params_from_jax``; ``weight_source`` "converted";
* ``npz``: the trio file read in place by ``distill.load_pretrained_with_cfg``;
  ``weight_source`` "distilled-istft".

The pipeline then sits in ``EgregoraAudioSuperResolution._PIPE``, where
the node keeps it between calls, on the card (``DEVICE`` "cuda"), and
``Upscaler.call`` calls the node as a ComfyUI graph calls it, ``run(audio,
lowpass_input=False, output_sr="48000")``; the returned AUDIO dict's
waveform is already on the host.  A call's units of work are its chunk
rows: 5.12 s chunks of the 48 kHz input (0.5 s overlap) times channels.

**Spans** (traced runs only): ``torch.profiler.record_function`` ranges
named ``pb.<layer>``, installed by wrapping the bound methods of the node,
the pipeline and its sub-models on their instances, and ``mha`` in the
namespaces of the model modules that call it; ``uninstall`` restores every
attribute.  The attention wrapper also records each call's shape and
dtype, which the roofline's bound is computed from.

**Faults**, planted under the timed path for the tests and the
calibration (the program's files are untouched), each a wrapper on a
method of the pipeline instance that ``undo`` removes:

* ``state_unchanged``: the model step hands its input back: the
  vocoder's wave is the input chunk itself, so nothing is synthesised;
* ``half_batch``: half of each chunk batch is left out, its rows filled
  with the mean of the rows computed;
* ``answer_altered``: the vocoder's wave of the last chunk row is
  negated where it is produced.

The exchange between chips does not exist in a one-chip cell.

**The check.** A sampled file is run again through the plain float32
reference (``perfbench/reference``), from the same inputs and the same
weights, and the served output is held against it by these numbers,
each pooled over the sample by ``harness.check``, on a 2048-point Hann STFT
(hop 512) of the 48 kHz outputs:

* ``wave_rel_l2``: every bin but each frame's merge region.  The
  adaptive merge edge, below which the input is copied and above which
  the model speaks, is a discrete choice of mel band that a bfloat16
  prediction may tip; the region runs from the lowest to the highest edge
  that a prediction within 0.5 nats can choose, for the chunks around the
  frame, widened by ``GUARD_HZ`` on both sides.  Below it the number sees
  the pipeline's signal processing, above it the model.
* ``high_band_rel_l2``: the bins at and above ``HIGH_BAND_HZ``, the
  model's alone (the edge lies at 11 kHz or below): a broken model, which
  the copied band would dilute in the whole wave, shows here.

An output that is not finite, or of another shape than the reference's,
is not correct whatever the numbers.
"""
from __future__ import annotations

import functools
import importlib
import json
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import weights
from perfbench.harness.traffic import Item

SR = 48000
CHUNK, CHUNK_HOP = 245760, 221760          # 5.12 s chunks, 0.5 s overlap, at 48 kHz
HIGH_BAND_HZ = 12000.0
GUARD_HZ = 1000.0          # the sigmoid step of the merge spans ~+-500 Hz
N_FFT, HOP = 2048, 512
NUMBERS = ("wave_rel_l2", "high_band_rel_l2")


# ---- the system ----

def port_config(geometry: Dict):
    """The port's ``FlashSRConfig`` for a geometry in the ``__config__``
    JSON format the trio files carry."""
    from egregora_tpu_torch.models.flashsr.distill import _cfg_from_json
    return _cfg_from_json(json.dumps(geometry))


def chunk_rows(item: Item) -> int:
    """Chunk rows of one call: chunks of the 48 kHz input times channels."""
    total = -(-item.samples.shape[-1] * SR // item.sr) if item.sr != SR \
        else item.samples.shape[-1]
    per_channel = 1 if total <= CHUNK else 1 + -(-(total - CHUNK) // CHUNK_HOP)
    return per_channel * item.samples.shape[0]


def build(config: Dict, root: Path, seed: int, device: str = "cuda") -> "Upscaler":
    """The cell's pipeline placed in the node's class cache, and a node
    instance to call."""
    from egregora_tpu_torch.models.flashsr import distill
    from egregora_tpu_torch.models.flashsr.pipeline import FlashSRModules, FlashSRPipeline
    from egregora_tpu_torch.nodes.super_resolution import EgregoraAudioSuperResolution
    from egregora_tpu_torch.utils.weights import (convert_state_dict, flax_tree,
                                                  params_from_jax)

    w = config["weights"]
    if w["kind"] == "upstream_seeded":
        cfg = port_config(config["geometry"])
        sds = weights.upstream_state_dicts(json.dumps(config["geometry"]), w["weight_seed"],
                                           seed, device)
        host = {n: {k: t.cpu().numpy() for k, t in sd.items()} for n, sd in sds.items()}
        del sds
        with torch.device("meta"):
            mods = FlashSRModules(cfg)
        maps = {"vae": distill.audioldm_vae_name_map(cfg.vae),
                "student_ldm": distill.ldm_unet_name_map(cfg.unet),
                "sr_vocoder": distill.hifigan_name_map(cfg.vocoder)}
        tree = {n: convert_state_dict(host[n], flax_tree(m), name_map=maps[n])
                for n, m in mods.by_name().items()}
        pipe = FlashSRPipeline(cfg, params=params_from_jax(cfg, tree), device=device)
        pipe.weight_source = "converted"
    elif w["kind"] == "npz":
        cfg, params = distill.load_pretrained_with_cfg(root / w["path"])
        if json.loads(distill._cfg_to_json(cfg)) != config["geometry"]:
            raise ValueError(f"{w['path']} carries another geometry than the configuration")
        pipe = FlashSRPipeline(cfg, params=params, device=device)
        pipe.weight_source = "distilled-istft"
    else:
        raise ValueError(f"unknown weights kind {w['kind']!r}")
    EgregoraAudioSuperResolution.DEVICE = device
    EgregoraAudioSuperResolution._PIPE = pipe
    return Upscaler(pipe, EgregoraAudioSuperResolution())


def release() -> None:
    """Drop the node's cached pipeline and the device memory it held."""
    import gc

    from egregora_tpu_torch.nodes.super_resolution import EgregoraAudioSuperResolution
    EgregoraAudioSuperResolution._PIPE = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Upscaler:
    """The served node and the pipeline in its class cache."""

    FAULTS = ("state_unchanged", "half_batch", "answer_altered")

    def __init__(self, pipe, node):
        self.pipe, self.node = pipe, node

    @property
    def weight_source(self) -> str:
        return self.pipe.weight_source

    def call(self, item: Item) -> np.ndarray:
        """The node's 48 kHz output ``[C, M]`` for one input file."""
        out = self.node.run(item.audio(), False, "48000")[0]
        return out["waveform"][0].numpy()

    rows = staticmethod(chunk_rows)

    def spans(self) -> "Spans":
        return Spans(self.node, self.pipe)

    def plant(self, name: str) -> None:
        attr, make = _PLANT[name]
        setattr(self.pipe, attr, make(self.pipe))

    def undo(self) -> None:
        for attr in ("synthesize", "chunk_forward"):
            vars(self.pipe).pop(attr, None)


# ---- spans ----

MHA_USERS = ("egregora_tpu_torch.models.flashsr.vae",
             "egregora_tpu_torch.models.flashsr.ldm_unet",
             "egregora_tpu_torch.models.flashsr.unet")


def _spanned(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


class Spans:
    """The traced run's spans over one node and its cached pipeline."""

    # outermost first: the innermost enclosing span names an idle gap
    NAMES = ("pb.node.run", "pb.process", "pb.synthesize", "pb.vae.encode", "pb.vae.decode",
             "pb.unet", "pb.vocoder", "pb.mha")

    def __init__(self, node, pipe):
        self.node, self.pipe = node, pipe
        self.attn_calls: List[Tuple[int, int, int, int, int]] = []   # (b, h, n, d, itemsize)
        self._saved: List[Tuple[object, str, object, bool]] = []

    def _wrap(self, owner, attr: str, name: str, fn: Callable = None) -> None:
        had = attr in vars(owner)
        self._saved.append((owner, attr, vars(owner).get(attr), had))
        setattr(owner, attr, _spanned(name, fn or getattr(owner, attr)))

    def install(self) -> "Spans":
        mods = self.pipe.modules
        self._wrap(self.node, "run", "pb.node.run")
        self._wrap(self.pipe, "process", "pb.process")
        self._wrap(self.pipe, "synthesize", "pb.synthesize")
        self._wrap(mods.vae, "encode", "pb.vae.encode")
        self._wrap(mods.vae, "decode", "pb.vae.decode")
        self._wrap(mods.unet, "forward", "pb.unet")
        self._wrap(mods.vocoder, "forward", "pb.vocoder")
        calls = self.attn_calls
        for path in MHA_USERS:
            module = importlib.import_module(path)
            mha = module.mha

            def counted(q, k, v, _mha=mha):
                b, h, n, d = q.shape
                calls.append((b, h, n, d, q.element_size()))
                return _mha(q, k, v)

            self._wrap(module, "mha", "pb.mha", counted)
        return self

    def uninstall(self) -> None:
        for owner, attr, old, had in reversed(self._saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._saved.clear()


# ---- faults ----

def _state_unchanged(pipe) -> Callable:
    orig = pipe.synthesize

    def synthesize(x):
        mel_hr, _ = orig(x)
        return mel_hr, x
    return synthesize


def _answer_altered(pipe) -> Callable:
    orig = pipe.synthesize

    def synthesize(x):
        mel_hr, wav = orig(x)
        wav = wav.clone()
        wav[-1] = -wav[-1]
        return mel_hr, wav
    return synthesize


def _half_batch(pipe) -> Callable:
    orig = pipe.chunk_forward

    def chunk_forward(chunks, lowpass_input=False):
        keep = max(1, chunks.shape[0] // 2)
        y = orig(chunks[:keep], lowpass_input=lowpass_input)
        rest = y.mean(dim=0, keepdim=True).expand((chunks.shape[0] - keep,) + y.shape[1:])
        return torch.cat([y, rest])
    return chunk_forward


_PLANT: Dict[str, tuple] = {"state_unchanged": ("synthesize", _state_unchanged),
                            "half_batch": ("chunk_forward", _half_batch),
                            "answer_altered": ("synthesize", _answer_altered)}


# ---- the check ----

def reference_outputs(config: Dict, root, seed: int, items: List[Item], device,
                      mode: str = "fp32") -> List[Tuple[np.ndarray, np.ndarray]]:
    """The reference's ``(output, possible merge edges)`` for ``items``, in
    ``mode`` ("fp32", or "control"); the output has the form ``call``
    returns."""
    from perfbench.reference import convert
    from perfbench.reference.pipeline import ReferenceFlashSR

    w = config["weights"]
    if w["kind"] == "npz":
        ref = ReferenceFlashSR.from_npz(root / w["path"], device)
    else:
        geom = json.dumps(config["geometry"])
        vae, unet, voc, opts = convert.config_from_json(geom)
        sds = weights.upstream_state_dicts(geom, w["weight_seed"], seed, device)
        ref = ReferenceFlashSR(vae, unet, voc, opts, device).load_upstream(sds)
    block = int(config.get("reference_block", 4))
    return [ref.process(item.samples, item.sr, SR, block=block, mode=mode) for item in items]


def _stft(x: torch.Tensor) -> torch.Tensor:
    """``[C, T] -> [C, bins, frames]`` (frame f centred at sample f * HOP)."""
    win = torch.hann_window(N_FFT, device=x.device)
    return torch.stft(x, N_FFT, HOP, window=win, return_complex=True)


def merge_regions(edges: np.ndarray, frames: int) -> np.ndarray:
    """``[C, frames, 2]``: each frame's merge region in Hz, from the lowest
    to the highest possible edge of the chunks its window touches
    (``edges`` ``[K, C, 2]``), widened by ``GUARD_HZ``."""
    k = edges.shape[0]
    centre = np.arange(frames) * HOP
    first = np.clip((centre - N_FFT // 2 - CHUNK) // CHUNK_HOP + 1, 0, k - 1)
    last = np.clip((centre + N_FFT // 2) // CHUNK_HOP, 0, k - 1)
    out = np.empty((edges.shape[1], frames, 2))
    for f in range(frames):
        near = edges[first[f]: last[f] + 1]
        out[:, f, 0] = near[..., 0].min(axis=0) - GUARD_HZ
        out[:, f, 1] = near[..., 1].max(axis=0) + GUARD_HZ
    return out


def sums(output: np.ndarray, reference: Tuple[np.ndarray, np.ndarray],
         device) -> Dict[str, float]:
    """One file's squared gaps and squared reference for each number
    (``nan`` where the output is unusable); ``reference`` is the
    reference's output and each chunk's possible merge edges ``[K, C, 2]``."""
    ref, edges = reference
    keys = [f"{n}_{part}" for n in NUMBERS for part in ("gap2", "ref2")]
    if output.shape != ref.shape or not np.all(np.isfinite(output)):
        return {k: float("nan") for k in keys}
    y = _stft(torch.from_numpy(np.ascontiguousarray(output, np.float32)).to(device))
    r = _stft(torch.from_numpy(np.ascontiguousarray(ref, np.float32)).to(device))
    freq = torch.arange(y.shape[-2], device=device, dtype=torch.float64)[:, None] * (SR / N_FFT)
    region = torch.from_numpy(merge_regions(np.asarray(edges), y.shape[-1])).to(device)
    inside = (freq[None] >= region[:, None, :, 0]) & (freq[None] < region[:, None, :, 1])
    bands = {"wave_rel_l2": ~inside,
             "high_band_rel_l2": (freq >= HIGH_BAND_HZ).expand(y.shape[-2:])[None]}
    res = {}
    gap2, ref2 = (torch.abs(y - r).double() ** 2), (torch.abs(r).double() ** 2)
    for name, mask in bands.items():
        mask = mask.expand(y.shape)
        res[f"{name}_gap2"] = float(gap2[mask].sum())
        res[f"{name}_ref2"] = float(ref2[mask].sum())
    return res
