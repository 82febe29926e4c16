"""The port's workflow executor (``egregora_tpu_torch.pipeline``).

The six cases of ``tests/test_pipeline_executor.py`` run on the port
with ``device="cpu"``; one graph of eval nodes (LoadAudio, Audio Gain Match
(1770), Loudness Meter (BS1770), Metrics (LSD + SI-SDR), Resample Audio
(HQ), SaveAudio) is held to the JAX executor on the same graph: the
metrics within 1e-3 (relative above 1), the resampled audio within 1e-4
and the saved WAVs within one PCM16 step after read-back; every node's
``DEVICE`` is restored after a run, also when a node raises; asked for
the card where there is none, ``run`` raises.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from egregora_tpu.pipeline.executor import WorkflowExecutor as JaxExecutor
from egregora_tpu_torch.nodes.base import DeviceNode
from egregora_tpu_torch.nodes.super_resolution import EgregoraAudioSuperResolution
from egregora_tpu_torch.pipeline.executor import BUILTIN_NODES, WorkflowExecutor
from egregora_tpu_torch.utils.profiling import NodeTimer
from egregora_tpu_torch.utils.wavio import read_audio, write_audio


def _ex(**kw):
    return WorkflowExecutor(timer=NodeTimer(), device="cpu", **kw)


@pytest.fixture
def wav(tmp_path):
    sr = 16000
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(sr // 2) / sr)).astype(np.float32)
    p = tmp_path / "in.wav"
    write_audio(p, x[None], sr)
    return str(p)


def test_linear_graph(wav, tmp_path):
    out_path = str(tmp_path / "out.wav")
    wf = {"nodes": [
        {"id": 1, "type": "LoadAudio", "inputs": {"path": wav}},
        {"id": 2, "type": "Resample Audio (HQ)",
         "inputs": {"audio": ["1", 0], "target_sr": 48000}},
        {"id": 3, "type": "SaveAudio", "inputs": {"audio": ["2", 0], "path": out_path}},
        {"id": 4, "type": "PreviewAudio", "inputs": {"audio": ["2", 0]}},
    ]}
    ex = _ex()
    results = ex.run(wf)
    assert results["3"][0] == out_path
    y, sr = read_audio(out_path)
    assert sr == 48000 and y.shape[1] == 24000
    assert results["4"][0]["sample_rate"] == 48000
    assert results["4"][0]["duration_s"] == 0.5
    summary = ex.timing_summary()
    assert summary["Resample Audio (HQ)"]["calls"] == 1
    assert summary["LoadAudio"]["calls"] == 1       # memoized despite two consumers


def test_enhance_graph(wav):
    wf = {"nodes": [
        {"id": "a", "type": "LoadAudio", "inputs": {"path": wav}},
        {"id": "b", "type": "EgregoraFatLlamaCPU",
         "inputs": {"AUDIO": ["a", 0], "target_format": "wav", "max_iterations": 4,
                    "threshold_value": 0.6, "target_bitrate_kbps": 1411}},
        {"id": "c", "type": "PreviewAudio", "inputs": {"audio": ["b", 0]}},
    ]}
    assert _ex().run(wf)["c"][0]["sample_rate"] == 96000


def test_overrides(wav):
    wf = {"nodes": [
        {"id": 1, "type": "LoadAudio", "inputs": {"path": "MISSING.wav"}},
        {"id": 2, "type": "PreviewAudio", "inputs": {"audio": ["1", 0]}},
    ]}
    ex = _ex()
    with pytest.raises(Exception):
        ex.run(json.loads(json.dumps(wf)))
    assert ex.run(wf, overrides={"1": {"path": wav}})["2"][0]["channels"] == 1


def test_unknown_node_type():
    wf = {"nodes": [{"id": 1, "type": "NopeNode", "inputs": {}}]}
    with pytest.raises(KeyError, match="NopeNode"):
        _ex().run(wf)


def test_cycle_detection():
    wf = {"nodes": [
        {"id": 1, "type": "PreviewAudio", "inputs": {"audio": ["2", 0]}},
        {"id": 2, "type": "PreviewAudio", "inputs": {"audio": ["1", 0]}},
    ]}
    with pytest.raises(ValueError, match="cycle"):
        _ex().run(wf)


def test_example_workflow_shape():
    """The shipped example graph parses and names node types the port knows."""
    import egregora_tpu_torch
    wf = json.loads((Path(__file__).parents[1] /
                     "examples/audio_super_resolution_workflow.json").read_text())
    known = set(BUILTIN_NODES) | set(egregora_tpu_torch.NODE_CLASS_MAPPINGS)
    for node in wf["nodes"]:
        assert node["type"] in known, node["type"]


def _pair(tmp_path):
    sr = 16000
    rng = np.random.default_rng(3)
    t = np.arange(sr) / sr
    a = (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(sr)).astype(np.float32)
    b = (0.7 * np.concatenate([np.zeros(3), a[:-3]])).astype(np.float32)
    write_audio(tmp_path / "a.wav", np.stack([a, 0.8 * a]), sr)
    write_audio(tmp_path / "b.wav", np.stack([b, 0.8 * b]), sr)


def _eval_graph(d: Path, tag: str):
    """The metrics read the 16 kHz pair itself: LSD over a resampled
    signal's empty band (above the source's Nyquist) follows float32
    roundoff in both packages (6.4 against 8.3 dB seen), as the log-mel
    floor does (ROADMAP Queue 3)."""
    return {"nodes": [
        {"id": 1, "type": "LoadAudio", "inputs": {"path": str(d / "a.wav")}},
        {"id": 2, "type": "LoadAudio", "inputs": {"path": str(d / "b.wav")}},
        {"id": 5, "type": "Audio Gain Match (1770)",
         "inputs": {"audio_ref": ["1", 0], "audio_in": ["2", 0]}},
        {"id": 6, "type": "Loudness Meter (BS1770)", "inputs": {"audio": ["5", 0]}},
        {"id": 7, "type": "Metrics (LSD + SI-SDR)",
         "inputs": {"audio_ref": ["1", 0], "audio_proc": ["5", 0]}},
        {"id": 3, "type": "Resample Audio (HQ)", "inputs": {"audio": ["5", 0],
                                                           "target_sr": 48000}},
        {"id": 8, "type": "SaveAudio", "inputs": {"audio": ["3", 0],
                                                  "path": str(d / f"{tag}.wav")}},
    ]}


def test_eval_graph_matches_the_jax_executor(tmp_path):
    _pair(tmp_path)
    got = _ex().run(_eval_graph(tmp_path, "t"))
    ref = JaxExecutor(timer=NodeTimer()).run(_eval_graph(tmp_path, "j"))
    for nid in ("6", "7"):
        assert got[nid][0].keys() == ref[nid][0].keys()
        for k, v in ref[nid][0].items():
            assert abs(got[nid][0][k] - v) <= 1e-3 * max(1.0, abs(v)), (nid, k)
    for i in (1, 2, 3):                      # gain_db, ref_level, in_level
        assert abs(got["5"][i] - ref["5"][i]) <= 1e-3
    np.testing.assert_allclose(got["3"][0]["samples"], np.asarray(ref["3"][0]["samples"]),
                               atol=1e-4)
    y, sr = read_audio(tmp_path / "t.wav")
    yj, sr_j = read_audio(tmp_path / "j.wav")
    assert sr == sr_j == 48000 and y.shape == yj.shape == (2, 48000)
    assert np.abs(y - yj).max() <= 1.0 / 32768


class _Boom:
    FUNCTION = "execute"

    def execute(self, audio):
        raise RuntimeError("boom")


def test_device_restored_after_a_node_raises(wav, monkeypatch):
    """The run sets every node's DEVICE to its device (the upscaler's
    through ``DeviceNode``); after a node raises they are back."""
    seen = []

    class Spy:
        FUNCTION = "execute"

        def execute(self, audio):
            seen.append((DeviceNode.DEVICE, EgregoraAudioSuperResolution.DEVICE))
            return (audio,)

    before = (DeviceNode.DEVICE, EgregoraAudioSuperResolution.DEVICE)
    wf = {"nodes": [
        {"id": 1, "type": "LoadAudio", "inputs": {"path": wav}},
        {"id": 2, "type": "Spy", "inputs": {"audio": ["1", 0]}},
        {"id": 3, "type": "Boom", "inputs": {"audio": ["2", 0]}},
    ]}
    with pytest.raises(RuntimeError, match="boom"):
        _ex(extra_nodes={"Spy": Spy, "Boom": _Boom}).run(wf)
    assert seen == [("cpu", "cpu")]
    assert (DeviceNode.DEVICE, EgregoraAudioSuperResolution.DEVICE) == before == ("cuda", "cuda")


def test_upscaler_pipeline_cached_per_device(monkeypatch):
    """The upscaler keeps its pipeline while DEVICE stays, and builds one
    for the new device when DEVICE changes."""
    import egregora_tpu_torch.models.flashsr.distill as distill
    import egregora_tpu_torch.nodes.super_resolution as sr_mod

    class FakePipe:
        def __init__(self, cfg, params=None, device="cuda"):
            self.device = torch.device(device)

    monkeypatch.setattr(distill, "resolve_flashsr", lambda: (None, None, "random"))
    monkeypatch.setattr(sr_mod, "FlashSRPipeline", FakePipe)
    monkeypatch.setattr(EgregoraAudioSuperResolution, "_PIPE", None)
    monkeypatch.setattr(DeviceNode, "DEVICE", "cpu")
    first = EgregoraAudioSuperResolution._pipeline()
    assert first.device.type == "cpu" and EgregoraAudioSuperResolution._pipeline() is first
    monkeypatch.setattr(DeviceNode, "DEVICE", "cuda")
    second = EgregoraAudioSuperResolution._pipeline()
    assert second is not first and second.device.type == "cuda"


def test_cuda_without_a_card_raises(wav):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    wf = {"nodes": [{"id": 1, "type": "LoadAudio", "inputs": {"path": wav}}]}
    with pytest.raises(RuntimeError, match="No CUDA device"):
        WorkflowExecutor(timer=NodeTimer()).run(wf)


def test_run_workflow_entry(wav, tmp_path, capsys):
    """The module entry on a graph of its own (``--workflow``): node 1's
    path set to the input, the last AUDIO node's output written."""
    from egregora_tpu_torch.pipeline import run_workflow
    wf = tmp_path / "wf.json"
    wf.write_text(json.dumps({"nodes": [
        {"id": 1, "type": "LoadAudio", "inputs": {"path": "in.wav"}},
        {"id": 2, "type": "Resample Audio (HQ)", "inputs": {"audio": ["1", 0],
                                                           "target_sr": 48000}},
        {"id": 3, "type": "PreviewAudio", "inputs": {"audio": ["2", 0]}}]}))
    out = tmp_path / "o.wav"
    assert run_workflow.main([wav, str(out), "--workflow", str(wf), "--device", "cpu"]) == 0
    assert "(node 2)" in capsys.readouterr().out
    y, sr = read_audio(out)
    assert sr == 48000 and y.shape == (1, 24000)
    assert run_workflow.EXAMPLE.exists()
