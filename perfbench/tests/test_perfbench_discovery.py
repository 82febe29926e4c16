"""A configuration, a system, a traffic mix, a per-layer metric and a cell
added as new files (and entries in ``BENCHMARK.json``) run with no edit to
any file that was there; a configuration that names no system, or one
with no module, fails with the file it looked for."""
import hashlib
import json
import time

import pytest

from perfbench.harness import main, spec
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


SYSTEM = '''"""A toy system: the input scaled by the configuration's gain on the
device; its reference scales it in float64, its control in float16."""
import numpy as np
import torch
from torch.profiler import record_function

NUMBERS = ("rel_l2",)


class Spans:
    NAMES = ("pb.toy.call",)

    def __init__(self, served):
        self.served, self.attn_calls = served, []

    def install(self):
        call = self.served.call

        def spanned(item):
            with record_function("pb.toy.call"):
                return call(item)
        self.served.call = spanned
        return self

    def uninstall(self):
        del self.served.call


class Scaler:
    FAULTS = ("answer_altered",)
    weight_source = "none"

    def __init__(self, gain, device):
        self.gain, self.device, self.sign = gain, device, 1.0

    def call(self, item):
        x = torch.from_numpy(item.samples).to(self.device)
        return (self.sign * self.gain * x).cpu().numpy()

    def rows(self, item):
        return item.samples.shape[0]

    def spans(self):
        return Spans(self)

    def plant(self, name):
        self.sign = -1.0

    def undo(self):
        self.sign = 1.0


def build(config, root, seed, device):
    return Scaler(config["gain"], device)


def release():
    pass


def reference_outputs(config, root, seed, items, device, mode):
    dtype = np.float16 if mode == "control" else np.float64
    return [((item.samples.astype(dtype) * config["gain"]).astype(np.float32), None)
            for item in items]


def sums(output, reference, device):
    ref = reference[0].astype(np.float64)
    gap2 = float(np.sum((output - ref) ** 2)) if output.shape == ref.shape else float("nan")
    return {"rel_l2_gap2": gap2, "rel_l2_ref2": float(np.sum(ref ** 2))}
'''

SPAN_READER = '''"""toy_calls (calls): the toy system's spans in the traced window."""


def read(ctx):
    return len(ctx.trace.spans["pb.toy.call"]) if ctx.trace is not None else None
'''


def test_new_system_is_found_by_name(tmp_path):
    bench = cpu_cell.small_bench(tmp_path, "flashsr_istft.music", seconds=(2.0, 2.5), pool=1)
    before = digests(bench)
    (bench / "systems" / "toy_scaler.py").write_text(SYSTEM)
    (bench / "configs" / "toy.json").write_text(json.dumps({"system": "toy_scaler", "gain": 0.5}))
    (bench / "limits" / "toy.music.json").write_text(json.dumps({"rel_l2": 1e-6}))
    (bench / "metrics" / "toy_calls.py").write_text(SPAN_READER)
    bm = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "toy", "source": "https://example.org/toy",
                          "file": "perfbench/configs/toy.json", "reduced": [], "why": "a test"})
    bm["workloads"].append({"name": "toy.music", "config": "toy", "traffic": "music",
                            "chips": 1, "why": "a test cell"})
    bm["per_layer"].append({"name": "toy_calls", "unit": "calls", "better": "lower",
                            "source": "program_span", "layer": "toy", "moves": "audio_rtf.music",
                            "workloads": ["toy.music"]})
    for m in bm["end_to_end"]:
        if m["name"] == "audio_rtf.music":
            m["workloads"].append("toy.music")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    line = cpu_cell.run(tmp_path, "toy.music")
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {"audio_rtf.music", "setup_s"}
    assert set(line["checks"]) == {"rel_l2", "files_compared"}
    line = cpu_cell.run(tmp_path, "toy.music", trace=1)
    assert line["correct"], line["checks"]
    assert line["metrics"]["toy_calls"]["value"] == line["attempted"]
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("named", [None, "no_such_system"])
def test_config_without_a_system_module_fails_naming_the_file(tmp_path, named):
    bench = cpu_cell.small_bench(tmp_path, "flashsr_istft.music", seconds=(2.0, 2.5), pool=1)
    path = bench / "configs" / "flashsr_istft.json"
    cfg = json.loads(path.read_text())
    cfg.pop("system")
    if named:
        cfg["system"] = named
    path.write_text(json.dumps(cfg))
    want = str(path) if named is None else str(bench / "systems" / f"{named}.py")
    with pytest.raises(LookupError, match=want):
        spec.system("flashsr_istft", bench)
    args = main.parse(["--workload", "flashsr_istft.music", "--seed", "1", "--seconds", "1",
                       "--trace", "0"])
    with pytest.raises(LookupError, match=str(path)):
        main.run_cell(args, time.time(), "cpu", root=tmp_path, bench_dir=bench)
