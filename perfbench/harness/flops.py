"""The benchmark's own arithmetic: operations and bytes from shapes, and
the chip's peaks (``peaks.json``).

* ``attention_bound_s``: the least time one exact attention call
  ``[B*H, N, D]`` can take, the larger of ``4 * BH * N^2 * D`` operations
  (the two products) over the peak rate of its dtype and its inputs and
  output (Q, K, V and O, each read or written once) over the memory
  bandwidth.  It counts the same work whatever implements the call.
* ``model_flops_per_chunk``: the operations of the three sub-models (VAE
  encode and decode, UNet, vocoder) on one 5.12 s chunk, counted by
  ``torch.utils.flop_counter`` over the reference's modules run on the
  meta device at the configuration's widths: every convolution,
  transposed convolution, matrix product and attention product, two
  operations a multiply-add; element-wise work is not counted.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

PEAKS = Path(__file__).with_name("peaks.json")


def peaks(device_name: str) -> Dict:
    """The peak table of the card whose name contains a key of
    ``peaks.json`` (e.g. "H100")."""
    table = json.loads(PEAKS.read_text())
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no peaks for {device_name!r} in {PEAKS}")


def attention_bound_s(b: int, h: int, n: int, d: int, itemsize: int, pk: Dict) -> float:
    flops = 4.0 * b * h * n * n * d
    rate = pk["flops_per_s"]["bf16" if itemsize == 2 else "fp32"]
    bytes_moved = 4.0 * b * h * n * d * itemsize
    return max(flops / rate, bytes_moved / pk["bytes_per_s"])


def attention_bound_total_s(calls: Iterable[Tuple[int, int, int, int, int]], pk: Dict) -> float:
    return sum(attention_bound_s(*c, pk) for c in calls)


@functools.lru_cache(maxsize=8)
def model_flops_per_chunk(geometry_json: str) -> float:
    """Operations of the trio on one chunk (see the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import convert
    from ..reference.pipeline import CHUNK, MEL_FRAMES, ReferenceFlashSR

    vae_cfg, unet_cfg, voc_cfg, opts = convert.config_from_json(geometry_json)
    with torch.device("meta"):
        ref = ReferenceFlashSR(vae_cfg, unet_cfg, voc_cfg, opts, device="meta")
        vae, unet, voc = (ref.modules[n] for n in ("vae", "student_ldm", "sr_vocoder"))
        mel = torch.empty(1, MEL_FRAMES, 256, 1)
        wave = torch.empty(1, CHUNK)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            z = vae.encode(mel)
            z_hr = unet(torch.cat([z, z], dim=-1), torch.ones(1))
            mel_hr = vae.decode(z_hr)[..., 0]
            voc(mel_hr, ref=wave)
    return float(counter.get_total_flops())
