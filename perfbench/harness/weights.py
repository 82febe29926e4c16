"""Seeded weights for a configuration that names upstream checkpoints.

The published FlashSR trio is not in the repository, so the benchmark
makes one of its geometry: the three upstream state dicts
(``vae.pth``, ``student_ldm.pth``, ``sr_vocoder.pth`` layouts, float32,
the vocoder weight-normalised), drawn on the device from one
``torch.Generator`` in one call and cut into tensors in the layout's
order.  Weights get lecun-normal scales (std ``fan_in ** -0.5``), biases
and norm shifts a spread of 0.02, norm scales ``1 + 0.1 N(0, 1)``, and
each weight-norm pair ``weight_v`` of unit spread with the ``weight_g``
that gives its folded weight the lecun scale.  The upstream VAE's
``loss.logvar``, which a converter has to drop, is included.

Nothing of the program is called: the layout comes from the reference's
own frozen name maps (``reference.convert.upstream_layout``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference import convert
from ..reference.pipeline import ReferenceFlashSR

MIX = 1_000_003


def draw_seed(weight_seed: int, seed: int) -> int:
    """The generator's seed for a configuration's weight seed and a run's
    ``--seed``."""
    return (int(weight_seed) * MIX + int(seed)) % (2 ** 63)


def layout(geometry_json: str):
    """The upstream layout of a geometry (``convert.upstream_layout``)."""
    vae, unet, voc, opts = convert.config_from_json(geometry_json)
    with torch.device("meta"):
        ref = ReferenceFlashSR(vae, unet, voc, opts, device="meta")
    return convert.upstream_layout(ref.modules, (vae, unet, voc))


def upstream_state_dicts(geometry_json: str, weight_seed: int, seed: int,
                         device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"vae": sd, "student_ldm": sd, "sr_vocoder": sd}`` of float32
    tensors on ``device``, the same for the same seeds on every run."""
    lay = layout(geometry_json)
    total = sum(math.prod(shape) for sd in lay.values() for shape, _, _ in sd.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(weight_seed, seed))
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, sd in lay.items():
        tensors = {}
        for key, (shape, role, fan_in) in sd.items():
            n = math.prod(shape)
            z = buf[at: at + n].view(shape)
            at += n
            if role == "weight":
                t = z * fan_in ** -0.5
            elif role == "norm_weight":
                t = 1.0 + 0.1 * z
            elif role == "weight_v":
                t = z
            elif role == "weight_g":
                per_row = math.prod(sd[key[:-1] + "v"][0][1:])
                t = (1.0 + 0.1 * z).abs() * math.sqrt(per_row / fan_in)
            else:                                     # bias, norm_bias
                t = 0.02 * z
            tensors[key] = t
        out[name] = tensors
    out["vae"]["loss.logvar"] = torch.zeros(1, device=device)
    return out


def parameter_count(geometry_json: str) -> int:
    """Parameters of the folded trio (a weight-norm pair counts as its
    weight)."""
    return sum(math.prod(shape) for sd in layout(geometry_json).values()
               for shape, role, _ in sd.values() if role != "weight_g")
