"""The traffic generator and the result line, on the CPU at tiny sizes."""
import json
import math

import numpy as np
import pytest

from perfbench.harness import spec, traffic
from perfbench.tests import cpu_cell

upscaler = spec.system("flashsr_published")


def tiny(name, pool=3, lo=1.0, hi=2.0):
    mix = spec.traffic(name)
    mix.update(pool=pool, length_s=dict(mix["length_s"], min=lo, max=hi))
    return mix


@pytest.mark.parametrize("name", ["voice", "music"])
def test_pool_is_seeded_and_16_bit(name):
    mix = tiny(name)
    a = traffic.make_pool(mix, 2 ** 33 + 1, "cpu")
    b = traffic.make_pool(mix, 2 ** 33 + 1, "cpu")
    c = traffic.make_pool(mix, 2 ** 33 + 2, "cpu")
    assert all(np.array_equal(x.samples, y.samples) for x, y in zip(a, b))
    assert any(not np.array_equal(x.samples, y.samples)
               for x, y in zip(sorted(a, key=lambda i: i.index), sorted(c, key=lambda i: i.index)))
    for item in a:
        assert item.samples.dtype == np.float32
        assert item.samples.shape[0] == mix["channels"]
        assert item.sr in mix["rates"]
        assert np.array_equal(np.round(item.samples * 32767.0), item.samples * 32767.0)
        assert 0.1 < np.abs(item.samples).max() <= 1.0
        audio = item.audio()
        assert tuple(audio["waveform"].shape) == (1,) + item.samples.shape


@pytest.mark.parametrize("name", ["voice", "music"])
def test_sizes_are_the_same_for_every_seed(name):
    mix = spec.traffic(name)
    sizes = traffic.sizes(mix)
    assert len(sizes) == mix["pool"]
    lo, hi = mix["length_s"]["min"], mix["length_s"]["max"]
    assert all(lo <= s["seconds"] <= hi for s in sizes)
    assert sorted(traffic.order(mix, 5)) == list(range(mix["pool"]))
    assert traffic.order(mix, 5) != traffic.order(mix, 6)


def test_chunk_rows_span_the_mixes_ranges():
    voice, music = (traffic.sizes(spec.traffic(n)) for n in ("voice", "music"))

    def rows(s, channels):
        n = int(round(s["seconds"] * s["sr"]))
        return upscaler.chunk_rows(traffic.Item(0, s["sr"], np.zeros((channels, n), np.float32)))

    assert {rows(s, 1) for s in voice} == set(range(1, 8))
    r = [rows(s, 2) for s in music]
    assert min(r) >= 52 and max(r) <= 130


def test_music_is_cut_at_its_edge():
    mix = tiny("music", pool=1, lo=2.0, hi=2.0)
    item = traffic.make_pool(mix, 9, "cpu")[0]
    spec_ = np.abs(np.fft.rfft(item.samples, axis=-1)) ** 2
    f = np.fft.rfftfreq(item.samples.shape[-1], 1.0 / item.sr)
    above = spec_[:, f > item.lowpass_hz + 300].sum()
    assert above < 1e-6 * spec_.sum()


def test_result_line_format(tmp_path):
    cpu_cell.small_bench(tmp_path, "flashsr_istft.music", seconds=(2.0, 2.5), pool=1)
    line = cpu_cell.run(tmp_path, "flashsr_istft.music")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    # the CPU has no peak memory counter: peak_mem_gib finds nothing to read
    assert set(line["metrics"]) == {"audio_rtf.music", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for k in ("wave_rel_l2", "high_band_rel_l2"):
        assert set(line["checks"][k]) == {"value", "limit"}
    json.dumps(line)


def test_merge_regions_follow_the_chunks():
    edges = np.array([[[8000.0, 8000.0]], [[3000.0, 11000.0]], [[9000.0, 9500.0]]])
    reg = upscaler.merge_regions(edges, 1300)
    hop = upscaler.CHUNK_HOP // upscaler.HOP
    assert list(reg[0, 0]) == [7000.0, 9000.0]                 # chunk 0 alone
    assert list(reg[0, hop + 10]) == [2000.0, 12000.0]         # chunks 0 and 1 overlap
    assert list(reg[0, 2 * hop + 300]) == [8000.0, 10500.0]    # chunk 2 alone
    assert list(reg[0, -1]) == [8000.0, 10500.0]               # past the last start: the last chunk
