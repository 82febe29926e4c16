"""The port's DAC codec against the benchmark's plain float32 reference
(``perfbench/reference/dac.py``, loaded by its path), on seeded weights
drawn in the upstream checkpoint's layout (``perfbench/systems/dac_codec.py``'s
draw, also loaded by its path) and converted by the port's own
``convert_state_dict`` and ``dac_name_map``.  Cases of one test:

* ``small_f32``: a narrow geometry (8-channel encoder, strides 2-4,
  64-channel decoder, 3 stages) with the port in float32, on 40 frames of
  stereo: the encoder's latents and the decode of the same latents within
  ``F32`` relative L2 (float32 sums in another order), and the port's codes
  cost nothing against the reference's quantizer walked along them
  (``walk``: a flip can only come from a tie);
* ``small_bf16``: the same geometry with the port in bfloat16, as served:
  latents and decode within ``BF16`` relative L2; bfloat16 keeps 8
  significant bits, so each conv, Snake and add a sample passes through
  rounds at ~2e-3, and the stacks read 6.2e-3 (latents) and 1.2e-2
  (decode); the control, the reference's products in fp8 (e4m3, 4
  significant bits), reads 0.12 on the decode and must fail the limit;
* ``published``: the published 44 kHz widths (76.6M parameters) on 3 codec
  frames of one channel, port in float32: latents and decode within
  ``F32``;
* ``conversion``: the port's converted weights against the reference's own
  conversion of the same upstream state dict (weight norm folded, the
  transposed convs' kernels flipped, the 1x1-conv projections squeezed,
  alphas flattened), each tensor within ``FOLD`` relative (the two fold
  the weight norm in float32 in another order).
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from egregora_tpu_torch.models.dac import model as T
from egregora_tpu_torch.utils.weights import convert_state_dict, flax_tree
from perfbench.reference.numerics import precision

ROOT = Path(__file__).resolve().parents[1]
F32, BF16, FOLD = 1e-5, 6e-2, 1e-6
SEED = 2 ** 33 + 5


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("dac_reference_under_test", "perfbench/reference/dac.py")
SYSTEM = _load("dac_codec_under_test", "perfbench/systems/dac_codec.py")
PUBLISHED = json.loads((ROOT / "perfbench/configs/dac44.json").read_text())["geometry"]
SMALL = dict(PUBLISHED, encoder_dim=8, strides=[2, 4], decoder_dim=64, n_codebooks=3)


def rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def pair(g, dtype):
    """(port ``DACModel`` in ``dtype``, reference) on the same upstream draw."""
    sd = SYSTEM.upstream_state_dict(g, 2306, SEED, "cpu")
    cfg = T.DACConfig(**dict(g, strides=tuple(g["strides"])), dtype=dtype)
    with torch.device("meta"):
        meta = T.DACModel(cfg)
    target = {n: flax_tree(getattr(meta, n)) for n in ("encoder", "decoder", "rvq")}
    tree = convert_state_dict({k: v.numpy() for k, v in sd.items()}, target,
                              name_map=T.dac_name_map(cfg))
    port = T.DACModel(cfg).load_jax(tree).eval()
    return port, REF.ReferenceDAC(g, REF.load_upstream(g, sd, "cpu"), "cpu")


def music(frames, channels, hop):
    g = torch.Generator().manual_seed(7)
    t = torch.arange(frames * hop) / 44100.0
    tone = sum(torch.sin(2 * np.pi * f * t) / (i + 1) for i, f in enumerate((110, 220, 330, 495)))
    return 0.2 * tone + 0.05 * torch.randn(channels, frames * hop, generator=g)


def check_codec(g, dtype, frames, channels, tol):
    port, ref = pair(g, dtype)
    x = music(frames, channels, REF.hop(g))
    with torch.no_grad():
        z_port = port.encoder(x[:, None]).float()
        z_ref = torch.stack([ref.encoder(x[c]) for c in range(channels)])
        assert rel(z_port.transpose(1, 2), z_ref) <= tol
        zq, codes = zip(*(ref.quantize(z) for z in z_ref))
        y_port = port.decode(torch.stack(zq))
        y_ref = torch.stack([ref.decoder(z) for z in zq])
    assert rel(y_port, y_ref) <= tol
    assert float(y_ref.abs().max()) < 0.99          # the seeded draw keeps the tanh unsaturated
    return port, ref, x, z_ref, zq, y_ref


@pytest.mark.parametrize("case", ["small_f32", "small_bf16", "published", "conversion"])
def test_port_matches_reference(case):
    if case == "small_f32":
        port, ref, x, z_ref, _, _ = check_codec(SMALL, torch.float32, 40, 2, F32)
        _, codes = port.encode(x)
        for c in range(2):
            excess, qerr = ref.walk(z_ref[c], codes[c])
            assert excess <= 1e-9 * qerr
            assert all(torch.unique(k).numel() > 1 for k in codes[c])
    elif case == "small_bf16":
        _, ref, _, _, zq, y_ref = check_codec(SMALL, torch.bfloat16, 40, 2, BF16)
        with precision("fp8"), torch.no_grad():
            y_control = torch.stack([ref.decoder(z) for z in zq])
        assert rel(y_control, y_ref) > BF16
    elif case == "published":
        check_codec(PUBLISHED, torch.float32, 3, 1, F32)
    else:
        port, ref = pair(SMALL, torch.float32)
        n = len(SMALL["strides"])
        p = ref.p
        got = {"encoder.Conv_0.weight": p.conv("encoder.block.0")[0],
               "encoder.EncoderBlock_1.ResidualUnit_2.Conv_0.weight":
                   p.conv("encoder.block.2.block.2.block.1")[0],
               "encoder.EncoderBlock_0.Snake_0.alpha": p.alpha("encoder.block.1.block.3"),
               f"decoder.DecoderBlock_{n - 1}.ConvTranspose_0.weight":
                   p.conv(f"decoder.model.{n}.block.1")[0],
               f"decoder.DecoderBlock_0.ResidualUnit_1.Conv_1.bias":
                   p.conv("decoder.model.1.block.3.block.3")[1],
               "decoder.Conv_1.weight": p.conv(f"decoder.model.{n + 2}")[0],
               "rvq.proj_in_2.weight": p.proj(2, "in_proj")[0],
               "rvq.proj_out_0.weight": p.proj(0, "out_proj")[0],
               "rvq.codebook_1": p.codebook(1)}
        sd = {k: v for k, v in port.state_dict().items()}
        assert len(sd) == sum(role != "weight_g" for _, role, _ in
                              REF.upstream_layout(SMALL).values())
        for key, want in got.items():
            assert sd[key].shape == want.shape, key
            assert rel(sd[key], want) <= FOLD, key

