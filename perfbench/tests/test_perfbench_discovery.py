"""A configuration, a traffic mix, a per-layer metric and a cell added as
new files (and entries in ``BENCHMARK.json``) run with no edit to any
file that was there."""
import hashlib
import json

from perfbench.harness import spec
from perfbench.tests import cpu_cell

READER = '''"""rows_per_call (rows): chunk rows a call, a mean over the window."""


def read(ctx):
    calls = ctx.window.calls
    return sum(c.rows for c in calls) / len(calls) if calls else None
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    bench = cpu_cell.small_bench(tmp_path, "flashsr_istft.music", seconds=(2.0, 2.5), pool=1)
    before = digests(bench)
    (bench / "configs" / "istft_copy.json").write_text(
        (bench / "configs" / "flashsr_istft.json").read_text())
    mix = json.loads((bench / "traffic" / "music.json").read_text())
    mix.update(channels=1, rates=[32000], signal="speech")
    (bench / "traffic" / "speech32k.json").write_text(json.dumps(mix))
    (bench / "metrics" / "rows_per_call.py").write_text(READER)
    (bench / "limits" / "istft_copy.speech32k.json").write_text(
        (bench / "limits" / "flashsr_istft.music.json").read_text())
    bm = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bm["configs"].append(dict(bm["configs"][1], name="istft_copy",
                              file="perfbench/configs/istft_copy.json"))
    bm["workloads"].append({"name": "istft_copy.speech32k", "config": "istft_copy",
                            "traffic": "speech32k", "chips": 1, "why": "a test cell"})
    bm["per_layer"].append({"name": "rows_per_call", "unit": "rows", "better": "higher",
                            "source": "program_counter", "layer": "pipeline DSP",
                            "moves": "audio_rtf.music", "workloads": ["istft_copy.speech32k"]})
    for m in bm["end_to_end"]:
        if m["name"] == "audio_rtf.music":
            m["workloads"].append("istft_copy.speech32k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    names = [m["name"] for m in spec.metrics_of("istft_copy.speech32k", "per_layer", tmp_path)]
    assert "rows_per_call" in names
    assert "rows_per_call" not in [m["name"] for m in
                                   spec.metrics_of("flashsr_istft.music", "per_layer", tmp_path)]
    assert spec.reader("audio_rtf.music", bench).__code__.co_filename.endswith("audio_rtf.py")
    line = cpu_cell.run(tmp_path, "istft_copy.speech32k")
    assert set(line["metrics"]) == {"audio_rtf.music", "setup_s"}
    line = cpu_cell.run(tmp_path, "istft_copy.speech32k", trace=1)
    assert line["metrics"]["rows_per_call"]["value"] == 1.0      # a mono 2 s file: one chunk row
    assert line["metrics"]["rows_per_call"]["unit"] == "rows"
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
