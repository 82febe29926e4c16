"""The port's full-chain example (``egregora_tpu_torch.examples.full_chain``)
against the repository's ``examples/full_chain.py``, on the CPU.

Both ``main``s on the same seeded speech-like 16 kHz stereo WAV (1.5 s,
``chip_smoke.speech_signal`` with its 50 ms quiet lead-in and no gap: a
zero-energy first frame makes RNNoise's pitch period follow FFT roundoff
in each package, ROADMAP Queue 3), with the weights each package serves
from an empty ``EGREGORA_TPU_WEIGHTS``: the shipped RNNoise weights and
istft trio.  1.5 s at 48 kHz is one FlashSR chunk a channel.  Measured
gaps, port against JAX (and the limits, 3x to 7x of them):

* the 96 kHz WAVs: relative L2 3.1e-3, max |d| 2.6e-3 (relative L2 1e-2);
  the gap is RNNoise's (near-ties in the pitch choice: 3.7e-3 max |d| on
  the same 48 kHz input of another seed) and FlashSR's (3.2e-3 relative
  on the same denoised input);
* loudness (LUFS, LRA): 8.7e-3 LU (0.03); true peak: 0.032 dB (0.15);
  SI-SDR: 0.0027 dB (0.02);
* LSD: 0.26 / 0.40 dB of ~94 / ~99 dB, mean / p95 (1.5 dB): the input's
  band above 8 kHz is empty, so LSD reads the output's high band over
  the log floor, where float32 roundoff lands (ROADMAP Queue 3);
* ``wall_s`` and ``realtime_factor`` are times: present in both, not
  compared.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from egregora_tpu.nodes import enhance_extras as j_nodes
from egregora_tpu_torch.examples import full_chain
from egregora_tpu_torch.nodes import enhance_extras as t_nodes
from egregora_tpu_torch.utils.wavio import read_audio, write_audio

ROOT = Path(__file__).resolve().parents[1]
SR = 16000
SECONDS = 1.5
WAVE_REL = 1e-2
KEY_LIMITS = {"lufs_integrated": 0.03, "lufs_momentary": 0.03, "lufs_short_term": 0.03,
              "lra": 0.03, "true_peak_dbfs": 0.15, "si_sdr_db": 0.02,
              "lsd_mean_db": 1.5, "lsd_p95_db": 1.5}
TIMES = ("wall_s", "realtime_factor")


def _jax_example():
    spec = importlib.util.spec_from_file_location("jax_full_chain",
                                                  ROOT / "examples" / "full_chain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed_json(out: str) -> dict:
    return json.loads(out[out.index("{"): out.rindex("}") + 1])


@pytest.fixture()
def wav(tmp_path, monkeypatch):
    """The input WAV, with the served weights read from an empty weights
    root (the node classes' weight caches emptied for the test)."""
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path / "weights"))
    monkeypatch.setattr(j_nodes.Egregora_RNNoise_Denoise, "_PARAMS", None)
    monkeypatch.setattr(t_nodes.Egregora_RNNoise_Denoise, "_PARAMS", None)
    path = tmp_path / "in.wav"
    x = chip_smoke.speech_signal(SECONDS, SR, 2, seed=0, gaps=())
    write_audio(path, x, SR)
    return path


def test_full_chain_matches_jax(wav, capsys):
    out_t, out_j = wav.with_name("port.wav"), wav.with_name("jax.wav")
    got = full_chain.main(str(wav), str(out_t), device="cpu")
    printed = capsys.readouterr().out
    assert _printed_json(printed) == got
    assert printed.splitlines()[0] == f"[load] {SECONDS:.1f}s @{SR} (2 ch)"
    assert "[flashsr] weights: distilled-istft" in printed
    assert "[device] cpu: " in printed
    _jax_example().main(str(wav), str(out_j))
    ref = _printed_json(capsys.readouterr().out)
    assert set(got) == set(ref) == set(KEY_LIMITS) | set(TIMES)
    for k, lim in KEY_LIMITS.items():
        assert abs(got[k] - ref[k]) <= lim, (k, got[k], ref[k])
    a, sr_a = read_audio(out_t)
    b, sr_b = read_audio(out_j)
    assert sr_a == sr_b == 96000 and a.shape == b.shape == (2, int(96000 * SECONDS))
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= WAVE_REL


def test_full_chain_function_takes_tensors(wav):
    """``full_chain`` on the tensors ``main`` reads gives what ``main``
    writes (one PCM16 step), and its stage times add up to the wall."""
    x, sr = read_audio(wav)
    out, metrics, stages = full_chain.full_chain(torch.from_numpy(x), sr, "cpu")
    assert out.shape == (2, int(96000 * SECONDS)) and out.dtype == torch.float32
    assert list(stages) == ["denoise", "flashsr", "enhance", "eval"]
    assert abs(sum(stages.values()) - metrics["wall_s"]) <= 0.01
    full_chain.main(str(wav), str(wav.with_name("out.wav")), device="cpu")
    y, _ = read_audio(wav.with_name("out.wav"))
    assert np.abs(y - out.numpy()).max() <= 1.0 / 32768 + 1e-6


def test_cuda_without_a_card_raises_and_writes_nothing(wav):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = wav.with_name("never.wav")
    with pytest.raises(RuntimeError, match="No CUDA device detected"):
        full_chain.main(str(wav), str(out))
    with pytest.raises(RuntimeError, match="No CUDA device detected"):
        full_chain.cli([str(wav), str(out), "--device", "cuda"])
    assert not out.exists()
