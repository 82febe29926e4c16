"""PyTorch port vs the JAX package: the command line.

The port's ``main(["--device", "cpu", ...])`` and the JAX ``main`` on the
same seeded WAVs (1.5 s of 16 kHz mono, and a copy delayed by 5 samples
at -2 dB), their printed JSON compared key by key and their output WAVs
after read-back.  Tolerances:

* ``loudness``: 1e-3 LU / dB (``tests/test_torch_eval.py``'s meter limit
  is of that order: the float32 K-weighting sums in another order);
* ``eval``: LSD 1e-3 dB, SI-SDR 1e-3 dB relative;
* ``nulltest``: delay and gain 1e-3, the metrics 1e-3 relative or 1e-2
  dB absolute (the null of a near-cancelled pair amplifies the float32
  order of sums);
* ``enhance``: the 96 kHz output within 2/32768 after read-back (one
  PCM16 step of each side's rounding; the IST loops agree to ~5e-7);
* ``codec`` (16 kHz, bf16 as served): the printed JSON (codes' shape,
  rates) exactly; each roundtrip's SNR against the input within 0.5 dB of
  the other's (``chip_smoke.py``'s DAC limit between card and CPU), and
  the two roundtrips within 0.1 relative L2 of each other (0.071 seen:
  in bf16 the RVQ's near-ties flip codes, ROADMAP Queue 3).

``flashsr`` is held to the port's own upscaler node on the same input (a
JAX CLI call compiles the whole pipeline; ``tests/test_torch_served.py``
already holds the node to the JAX package).
"""
import json

import numpy as np
import pytest
import torch

from egregora_tpu.cli import build_parser as j_build_parser
from egregora_tpu.cli import main as j_main
from egregora_tpu_torch import cli
from egregora_tpu_torch.utils.wavio import read_audio, write_audio

SR = 16000
STEP = 1.0 / 32768.0


def _signal(seconds=1.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = sum(np.sin(2 * np.pi * 220.0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 12))
    x = x + 0.02 * rng.standard_normal(t.shape)
    return (0.4 * x / np.abs(x).max()).astype(np.float32)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    x = _signal()
    y = (np.concatenate([np.zeros(5, np.float32), x[:-5]]) * 10 ** (-2 / 20)).astype(np.float32)
    write_audio(d / "ref.wav", x[None], SR)
    write_audio(d / "proc.wav", y[None], SR)
    return d, str(d / "ref.wav"), str(d / "proc.wav")


def _json(capsys, fn, argv):
    assert fn(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def test_parser_takes_every_flag_of_the_jax_parser():
    flags = ["flashsr", "--ckpt-dir", "/tmp/x", "--in", "a.wav", "--out", "b.wav",
             "--target-sr", "96000", "--lowpass-input", "--device", "cuda"]
    args = cli.build_parser().parse_args(flags)
    ref = j_build_parser().parse_args(flags)
    assert (args.target_sr, args.ckpt_dir, args.infile, args.outfile, args.lowpass_input) == \
        (ref.target_sr, ref.ckpt_dir, ref.infile, ref.outfile, ref.lowpass_input)
    assert args.flashsr_device == "cuda" and args.device == "cuda"
    assert cli.build_parser().parse_args(["--device", "cpu", "loudness", "--in", "a"]).device == "cpu"
    for sub in ("enhance", "eval", "nulltest", "codec", "loudness"):
        j_sub = j_build_parser()._subparsers._group_actions[0].choices[sub]
        t_sub = cli.build_parser()._subparsers._group_actions[0].choices[sub]
        assert ({a.dest for a in j_sub._actions} == {a.dest for a in t_sub._actions}), sub


def test_cuda_without_a_card_raises(wavs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["loudness", "--in", wavs[1]])
    with pytest.raises(RuntimeError, match="No CUDA device"):
        cli.main(["--device", "cpu", "flashsr", "--in", wavs[1], "--out", "x.wav",
                  "--device", "cuda"])


def test_loudness_matches_jax(wavs, capsys):
    got = _json(capsys, cli.main, ["--device", "cpu", "loudness", "--in", wavs[2]])
    ref = _json(capsys, j_main, ["loudness", "--in", wavs[2]])
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3, (k, got[k], ref[k])


def test_eval_matches_jax(wavs, capsys):
    argv = ["eval", "--ref", wavs[1], "--proc", wavs[2]]
    got = _json(capsys, cli.main, ["--device", "cpu"] + argv)
    ref = _json(capsys, j_main, argv)
    assert got.keys() == ref.keys()
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3 * max(1.0, abs(ref[k])), (k, got[k], ref[k])


def test_nulltest_matches_jax(wavs, capsys):
    argv = ["nulltest", "--ref", wavs[1], "--proc", wavs[2]]
    got = _json(capsys, cli.main, ["--device", "cpu"] + argv)
    ref = _json(capsys, j_main, argv)
    assert got.keys() == ref.keys()
    assert abs(got["delay_ms"] - ref["delay_ms"]) <= 1e-3
    assert abs(got["gain_db"] - ref["gain_db"]) <= 1e-3
    for k in ref:
        tol = 1e-2 if k.endswith(("_db", "dbfs", "_lufs")) else 1e-3 * max(1.0, abs(ref[k]))
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


def test_enhance_matches_jax(wavs, capsys):
    d, ref_wav, _ = wavs
    argv = ["enhance", "--in", ref_wav, "--iterations", "4"]
    assert cli.main(["--device", "cpu"] + argv + ["--out", str(d / "t_enh.wav")]) == 0
    assert j_main(argv + ["--out", str(d / "j_enh.wav")]) == 0
    got, sr = read_audio(d / "t_enh.wav")
    ref, j_sr = read_audio(d / "j_enh.wav")
    assert sr == j_sr == 6 * SR and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 2 * STEP


def test_codec_matches_jax(wavs, capsys, tmp_path, monkeypatch):
    from egregora_tpu.models.dac import model as j_dac
    from egregora_tpu_torch.models.dac import model as t_dac
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.setattr(j_dac, "_CACHE", {})
    monkeypatch.setattr(t_dac, "_CACHE", {})
    d, ref_wav, _ = wavs
    argv = ["codec", "--in", ref_wav, "--model-type", "16khz"]
    got = _json(capsys, cli.main, ["--device", "cpu"] + argv + ["--out", str(d / "t_rt.wav")])
    ref = _json(capsys, j_main, argv + ["--out", str(d / "j_rt.wav")])
    assert got == ref
    y, sr = read_audio(d / "t_rt.wav")
    yj, j_sr = read_audio(d / "j_rt.wav")
    assert sr == j_sr == SR and y.shape == yj.shape
    x = read_audio(ref_wav)[0]

    def snr(z):
        return 10 * np.log10(np.sum(x ** 2) / np.sum((x - z) ** 2))

    assert abs(snr(y) - snr(yj)) <= 0.5, (snr(y), snr(yj))
    rel = np.linalg.norm(y - yj) / np.linalg.norm(yj)
    assert rel <= 0.1, rel


def test_flashsr_matches_the_node(wavs, tmp_path, monkeypatch, capsys):
    """The istft trio on the CPU: the CLI's WAV against the upscaler node
    on the same input, within one PCM16 step."""
    from egregora_tpu_torch.nodes.base import node_device
    from egregora_tpu_torch.nodes.super_resolution import EgregoraAudioSuperResolution as up
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.delenv("EGREGORA_FLASHSR_VARIANT", raising=False)
    d, ref_wav, _ = wavs
    out = str(d / "t_sr.wav")
    assert cli.main(["flashsr", "--in", ref_wav, "--out", out, "--device", "cpu"]) == 0
    assert "weights: distilled-istft" in capsys.readouterr().out
    got, sr = read_audio(out)
    monkeypatch.setattr(up, "_PIPE", None)
    with node_device("cpu"):
        (node_out,) = up().run({"waveform": torch.from_numpy(read_audio(ref_wav)[0][None]),
                                "sample_rate": SR}, False, "48000")
    want = node_out["waveform"][0].numpy()
    assert sr == 48000 and got.shape == want.shape == (1, int(1.5 * 48000))
    assert np.abs(got - want).max() <= STEP
