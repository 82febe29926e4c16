"""Whether the timed path produced the right audio.

After the window has closed, a sample of the files it served (drawn from
the seed, always with the pool's longest file in it) is run again through
the plain float32 reference (``perfbench/reference``), from the same
inputs and the same weights, and the served outputs are held against the
reference's by two numbers, each pooled over the sample (the summed
squared gap of all its files over their summed squared reference), on a
2048-point Hann STFT (hop 512) of the 48 kHz outputs:

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

Pooled, not the worst file: a file's gap mixes the bands by that file's
energy, and a quiet, pause-heavy file read several times its neighbours
while the model's gap was the same (``PERF.md``).  A sampled file that
raised, an output that is not finite, or one of another shape than the
reference's is not correct whatever the numbers.  The limits are the
cell's, in ``perfbench/limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

HIGH_BAND_HZ = 12000.0
GUARD_HZ = 1000.0          # the sigmoid step of the merge spans ~+-500 Hz
SR = 48000
N_FFT, HOP = 2048, 512
CHUNK, CHUNK_HOP = 245760, 221760
NUMBERS = ("wave_rel_l2", "high_band_rel_l2")


def sample_indices(pool_sizes: List[Dict], n: int, seed: int) -> List[int]:
    """Pool indices of the sample: the longest file and ``n - 1`` others
    drawn from ``seed``."""
    longest = max(pool_sizes, key=lambda s: s["seconds"])["index"]
    rest = [s["index"] for s in pool_sizes if s["index"] != longest]
    rng = np.random.default_rng([int(seed), 2])
    return [longest] + [int(i) for i in rng.choice(rest, size=min(n - 1, len(rest)),
                                                    replace=False)]


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


def sums(out: np.ndarray, ref: np.ndarray, edges: np.ndarray, device) -> Dict[str, float]:
    """One file's squared gaps and squared reference for each number
    (``nan`` where the output is unusable); ``edges`` ``[K, C, 2]`` are
    each chunk's possible merge edges from the reference."""
    keys = [f"{n}_{part}" for n in NUMBERS for part in ("gap2", "ref2")]
    if out.shape != ref.shape or not np.all(np.isfinite(out)):
        return {k: float("nan") for k in keys}
    y = _stft(torch.from_numpy(np.ascontiguousarray(out, np.float32)).to(device))
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


def pooled(files: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number over a set of files: the root of their summed squared
    gap over their summed squared reference."""
    if not files:
        return {k: float("nan") for k in NUMBERS}
    out = {}
    for k in NUMBERS:
        gap2 = sum(f[f"{k}_gap2"] for f in files)
        ref2 = sum(f[f"{k}_ref2"] for f in files)
        # a band with no bin in it gaps by nothing
        out[k] = math.sqrt(gap2 / ref2) if ref2 > 0 else (0.0 if gap2 == 0 else math.inf)
    return out


@dataclasses.dataclass
class Verdict:
    correct: bool
    numbers: Dict[str, float]        # each number pooled over the sample
    limits: Dict[str, float]
    compared: int
    reason: str = ""

    def lines(self) -> List[str]:
        out = [f"{k} {self.numbers[k]:.6g} limit {self.limits[k]:.6g}" for k in NUMBERS]
        out.append(f"files compared {self.compared}")
        return out

    def record(self) -> Dict:
        """The result line's ``checks``: each number beside its limit."""
        rec = {k: {"value": self.numbers[k], "limit": self.limits[k]} for k in NUMBERS}
        rec["files_compared"] = self.compared
        return rec


def judge(files: List[Dict[str, float]], limits: Dict[str, float],
          failed: int, expected: int) -> Verdict:
    """Each number, pooled over the compared files, held to its limit."""
    numbers = pooled(files)
    ok = bool(files) and all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                             for k in NUMBERS)
    reason = ""
    if failed:
        ok, reason = False, f"{failed} call(s) raised"
    elif not files:
        reason = "no sampled file was served"
    elif len(files) < expected:
        reason = f"{expected - len(files)} sampled file(s) not served in the window"
    return Verdict(ok, numbers, dict(limits), len(files), reason)


def reference_outputs(config: Dict, root, seed: int, inputs: List, device,
                      mode: str = "fp32") -> List:
    """The reference's ``(output, possible merge edges)`` for ``inputs``
    (traffic items), in ``mode`` ("fp32", or "control")."""
    import json

    from ..reference import convert
    from ..reference.pipeline import ReferenceFlashSR
    from . import weights

    w = config["weights"]
    if w["kind"] == "npz":
        ref = ReferenceFlashSR.from_npz(root / w["path"], device)
    else:
        geom = json.dumps(config["geometry"])
        vae, unet, voc, opts = convert.config_from_json(geom)
        sds = weights.upstream_state_dicts(geom, w["weight_seed"], seed, device)
        ref = ReferenceFlashSR(vae, unet, voc, opts, device).load_upstream(sds)
    block = int(config.get("reference_block", 4))
    return [ref.process(item.samples, item.sr, 48000, block=block, mode=mode) for item in inputs]
