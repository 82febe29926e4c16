"""The reference against the port computed in float32 on the CPU (the
same inputs and weights; bf16 and the kernels aside they are one
computation), and its control: the fp8 products fail the cells' limits
where the port's bf16 passes them."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench.harness import check, spec, traffic, weights
from perfbench.reference import convert
from perfbench.reference.pipeline import ReferenceFlashSR
from perfbench.tests.cpu_cell import NARROW

system = spec.system("flashsr_published")


def narrow_geometry():
    geom = spec.config("flashsr_published")["geometry"]
    for part, keys in NARROW.items():
        geom[part].update(keys)
    return geom


def speech(seconds=6.0, sr=22050, channels=1):
    mix = spec.traffic("voice")
    mix.update(pool=1, length_s=dict(mix["length_s"], min=seconds, max=seconds), rates=[sr])
    return traffic.make_pool(mix, 3, "cpu")[0]


def float32_port(pipe):
    from egregora_tpu_torch.models.flashsr.pipeline import FlashSRPipeline
    f32 = torch.float32
    c = pipe.cfg
    cfg = dataclasses.replace(c, vae=dataclasses.replace(c.vae, dtype=f32),
                              unet=dataclasses.replace(c.unet, dtype=f32),
                              vocoder=dataclasses.replace(c.vocoder, dtype=f32))
    params = {n: m.state_dict() for n, m in pipe.modules.by_name().items()}
    return FlashSRPipeline(cfg, params=params, device="cpu")


def port_output(pipe, item):
    from egregora_tpu_torch.core.audio import AudioBuffer
    return pipe.process(AudioBuffer(item.samples, item.sr, {}), output_sr=48000).numpy()


@pytest.fixture(scope="module")
def published():
    geom = narrow_geometry()
    served = system.build({"weights": {"kind": "upstream_seeded", "weight_seed": 2501},
                           "geometry": geom}, spec.ROOT, 5, "cpu")
    sds = weights.upstream_state_dicts(json.dumps(geom), 2501, 5, "cpu")
    ref = ReferenceFlashSR(*convert.config_from_json(json.dumps(geom)), "cpu").load_upstream(sds)
    return served, ref


@pytest.fixture(scope="module")
def istft():
    cfg = spec.config("flashsr_istft")
    cfg["weights"]["path"] = str(spec.ROOT / cfg["weights"]["path"])
    served = system.build(cfg, spec.ROOT, 5, "cpu")
    return served, ReferenceFlashSR.from_npz(cfg["weights"]["path"], "cpu")


@pytest.mark.parametrize("which", ["published", "istft"])
def test_reference_is_the_port_in_float32(which, request):
    served, ref = request.getfixturevalue(which)
    item = speech()
    y = port_output(float32_port(served.pipe), item)
    r, edges = ref.process(item.samples, item.sr)
    assert y.shape == r.shape and edges.shape == (2, 1, 2)
    assert np.linalg.norm(y - r) / np.linalg.norm(r) < 1e-5


def test_seeded_weights_are_the_published_geometry():
    geom = json.dumps(spec.config("flashsr_published")["geometry"])
    assert weights.parameter_count(geom) == 128_490_978
    sds = weights.upstream_state_dicts(json.dumps(narrow_geometry()), 2501, 5, "cpu")
    again = weights.upstream_state_dicts(json.dumps(narrow_geometry()), 2501, 5, "cpu")
    other = weights.upstream_state_dicts(json.dumps(narrow_geometry()), 2501, 6, "cpu")
    assert set(sds) == {"vae", "student_ldm", "sr_vocoder"}
    assert "loss.logvar" in sds["vae"] and "conv_pre.weight_g" in sds["sr_vocoder"]
    assert sds["student_ldm"]["middle_block.1.qkv.weight"].dim() == 3
    for name in sds:
        for k in sds[name]:
            assert torch.equal(sds[name][k], again[name][k])
    assert not torch.equal(sds["vae"]["encoder.conv_in.weight"],
                           other["vae"]["encoder.conv_in.weight"])


@pytest.mark.parametrize("which,cell", [("published", "flashsr_published.voice"),
                                        ("istft", "flashsr_istft.music"),
                                        ("published", "flashsr_published.music")])
def test_control_fails_where_the_port_passes(which, cell, request):
    served, ref = request.getfixturevalue(which)
    type(served.node)._PIPE = served.pipe    # the node's class cache holds the last pipeline built
    lim = spec.limits(cell)
    item = speech()
    r = ref.process(item.samples, item.sr)
    y = served.call(item)
    sound = check.pooled([system.sums(y, r, "cpu")], system.NUMBERS)
    control = check.pooled([system.sums(ref.process(item.samples, item.sr, mode="control")[0], r,
                                        "cpu")], system.NUMBERS)
    assert all(sound[k] <= lim[k] for k in system.NUMBERS), sound
    assert any(control[k] > lim[k] for k in system.NUMBERS), control
