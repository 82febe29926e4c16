"""The ``dac_codec`` system and the ``dac44.music`` cell on the CPU: the
seeded upstream draw, the reference loading nothing of the port or JAX,
the counts the readers use against hand counts and
``torch.utils.flop_counter``, the readers on a made-up window, the
control against the cell's limits, a whole run of the cell added as new
files (traced and not), and each planted fault seen as not correct.
Runs that drive the port use the published geometry narrowed to an
8-channel encoder and a 64-channel decoder (the strides, the hop and the
quantizer kept) on songs of 1-1.5 s."""
import json
import types

import numpy as np
import pytest
import torch

from perfbench.harness import check, spec, traffic
from perfbench.harness.trace import Reduced
from perfbench.reference import dac
from perfbench.tests import cpu_cell

CELL = "dac44.music"
NARROW = {"encoder_dim": 8, "decoder_dim": 64}
system = spec.system("dac44")


def narrowed(cfg):
    cfg = json.loads(json.dumps(cfg))
    cfg["geometry"].update(NARROW)
    return cfg


def test_seeded_weights_are_the_published_geometry():
    g = spec.config("dac44")["geometry"]
    assert dac.parameter_count(g) == 76_620_777
    small = narrowed(spec.config("dac44"))["geometry"]
    sd = system.upstream_state_dict(small, 2306, 5, "cpu")
    again = system.upstream_state_dict(small, 2306, 5, "cpu")
    other = system.upstream_state_dict(small, 2306, 6, "cpu")
    assert list(sd) == list(dac.upstream_layout(small))
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["encoder.block.0.weight_v"], other["encoder.block.0.weight_v"])
    assert sd["decoder.model.1.block.1.weight_v"].shape == (64, 32, 16)    # [in, out, k]
    folded = dac.fold(sd)

    def std(key):
        return float(folded[key].std())
    # the lecun scale, 0.3 of it on a residual unit's 1x1 conv, 0.1 on the output conv
    assert std("decoder.model.0.weight") == pytest.approx((7 * 128) ** -0.5, rel=0.1)
    assert std("encoder.block.1.block.0.block.3.weight") == pytest.approx(0.3 * 8 ** -0.5, rel=0.3)
    assert std("decoder.model.6.weight") == pytest.approx(0.1 * (7 * 4) ** -0.5, rel=0.3)
    alphas = torch.cat([v.flatten() for k, v in sd.items() if k.endswith("alpha")])
    assert 0.5 <= float(alphas.min()) and float(alphas.max()) <= 1.5


def test_reference_loads_no_jax_and_nothing_of_the_port():
    from perfbench.tests.test_perfbench_isolation import FORBIDDEN, loaded
    assert not loaded("import perfbench.reference.dac") & set(FORBIDDEN + ["egregora_tpu_torch"])


def test_counts_from_shapes():
    from torch.utils.flop_counter import FlopCounterMode

    g = spec.config("dac44")["geometry"]
    shapes = dac.snake_shapes(g, 1)
    assert len(shapes) == 58
    assert sum(c * n for c, n in shapes) == 2945 * 512       # elements a sample, by hand
    assert shapes[0] == (64, 512) and shapes[28] == (1024, 1) and shapes[-1] == (96, 512)
    assert dac.flops_per_frame(g) / 512 == pytest.approx(4.531e6, rel=1e-3)
    frames = 4
    with torch.device("meta"):
        sd = {k: torch.empty(s) for k, (s, _, _) in dac.upstream_layout(g).items()}
        ref = dac.ReferenceDAC(g, dac.Params(g, sd), "meta")
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            z = ref.encoder(torch.empty(frames * 512))
            residual = z
            for q in range(g["n_codebooks"]):
                r = ref._proj(residual, q, "in_proj")
                d2 = (2.0 * r) @ ref.p.codebook(q).T
                residual = residual - ref._proj(r, q, "out_proj")
            ref.decoder(z)
    assert counter.get_total_flops() == pytest.approx(frames * dac.flops_per_frame(g), rel=1e-9)
    assert d2.shape == (frames, 1024)


def _ctx(spans, dev_ms, rows):
    dev = np.asarray([[100.0 + a / 1e3, 100.0 + b / 1e3] for a, b in dev_ms]).reshape(-1, 2)
    sp = {n: np.asarray([[100.0 + a / 1e3, 100.0 + b / 1e3] for a, b in v]).reshape(-1, 2)
          for n, v in spans.items()}
    launched = dev[:, 0]
    under = {n: np.array([any(a <= t < b for a, b in sp[n]) for t in launched]) for n in sp}
    red = Reduced(100.0, 101.0, sp, dev, ["k"] * len(dev), under, {}, tuple(sp))
    call = types.SimpleNamespace(rows=rows, ok=True, seconds=1.0)
    window = types.SimpleNamespace(calls=[call], t0=0.0, t_end=1.0)
    return types.SimpleNamespace(trace=red, config=spec.config("dac44"), window=window,
                                 rows_done=lambda: rows,
                                 peaks=lambda: {"bytes_per_s": 3.35e12,
                                                "flops_per_s": {"bf16": 989e12}})


# one call: encode 0-400 ms (encoder 50-250, rvq 250-300), decode 500-900 (decoder 520-880);
# the card busy 60-240, 250-290, 530-870 ms; Snakes 60-100 and 600-700
SPANS = {"egr.node.dac_encode": [(0, 400)], "egr.node.dac_decode": [(500, 900)],
         "egr.dac.encoder": [(50, 250)], "egr.dac.rvq": [(250, 300)],
         "egr.dac.decoder": [(520, 880)], "egr.dac.snake": [(55, 100), (595, 700)]}
DEV = [(60, 240), (250, 290), (530, 600), (600, 700), (700, 870)]


@pytest.mark.parametrize("metric,want", [
    # node spans idle 400 - 220 + 400 - 340 = 240; model spans idle 20 + 10 + 20 = 50
    ("codec_idle_ms", 190.0),
    # 172 frames of 512 at 44.1 kHz: 1.99692 channel-seconds
    ("dac_encoder_ms_per_s", 180.0 / (172 * 512 / 44100)),
    ("dac_rvq_ms_per_s", 40.0 / (172 * 512 / 44100)),
    ("dac_decoder_ms_per_s", 340.0 / (172 * 512 / 44100)),
    ("snake_roofline", 100.0 * 4 * 172 * 2945 * 512 / 3.35e12 / 0.28),
    ("step_mfu_pct.dac44", 100.0 * 172 * 2319990784 / 1.0 / 989e12),
])
def test_readers_on_a_made_up_window(metric, want):
    assert spec.reader(metric)(_ctx(SPANS, DEV, 172)) == pytest.approx(want, rel=1e-6)
    empty = {n: [] for n in SPANS}
    if metric != "step_mfu_pct.dac44":
        assert spec.reader(metric)(_ctx(empty, DEV, 172)) is None


@pytest.fixture(scope="module")
def narrow_served():
    served = system.build(narrowed(spec.config("dac44")), spec.ROOT, 5, "cpu")
    yield served
    system.release()


def song(seconds=1.2):
    mix = spec.traffic("music")
    mix.update(pool=1, length_s=dict(mix["length_s"], min=seconds, max=seconds))
    return traffic.make_pool(mix, 3, "cpu")[0]


def test_control_fails_where_the_port_passes(narrow_served):
    cfg = narrowed(spec.config("dac44"))
    lim = spec.limits(CELL)
    item = song()
    ref = system.reference_outputs(cfg, spec.ROOT, 5, [item], "cpu", "fp32")[0]
    sound = check.pooled([system.sums(narrow_served.call(item), ref, "cpu")], system.NUMBERS)
    control = system.reference_outputs(cfg, spec.ROOT, 5, [item], "cpu", "control")[0][0]
    control = check.pooled([system.sums(control, ref, "cpu")], system.NUMBERS)
    assert all(sound[k] <= lim[k] for k in system.NUMBERS), sound
    assert any(control[k] > lim[k] for k in system.NUMBERS), control


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    root = tmp_path_factory.mktemp(CELL)
    bench = cpu_cell.small_bench(root, CELL, seconds=(1.0, 1.5), pool=2)
    path = bench / "configs" / "dac44.json"
    path.write_text(json.dumps(narrowed(json.loads(path.read_text()))))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(bench, trace):
    line = cpu_cell.run(bench, CELL, trace=trace)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(system.NUMBERS) | {"files_compared"}
    if trace:          # no device events on the CPU: every per-layer reader finds nothing
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"audio_rtf", "setup_s"}


@pytest.mark.parametrize("fault", system.Codec.FAULTS)
def test_fault_is_not_correct(bench, fault, monkeypatch):
    found = spec.system

    def broken_system(*args, **kwargs):
        module = found(*args, **kwargs)
        build = module.build

        def broken(*args, **kwargs):
            served = build(*args, **kwargs)
            served.plant(fault)
            return served

        monkeypatch.setattr(module, "build", broken)
        return module

    monkeypatch.setattr(spec, "system", broken_system)
    line = cpu_cell.run(bench, CELL)
    assert not line["correct"], line["checks"]
