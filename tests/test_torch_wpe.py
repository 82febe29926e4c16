"""PyTorch port vs the JAX package: WPE dereverberation and its node.

Same inputs (numpy, seeded) through ``egregora_tpu`` and
``egregora_tpu_torch`` on the CPU, in float32 / complex64.  Tolerances:

* ``_stack_taps``: exact (a shift);
* ``wpe`` on a random complex STFT: max |d| <= 1e-4 of the largest
  output (both solve the same [F] Hermitian systems with a library
  solve, in other orders);
* ``wpe_dereverb`` on 1 s of reverberant stereo at n_fft 256: max |d|
  <= 1e-3 (|x| ~ 0.5; the solves of a nearly tonal signal are
  ill-conditioned at ~1e-4 relative);
* the node with B = 2 against per-item calls of itself: 1e-5 (the same
  arithmetic), and against the JAX node: 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egregora_tpu.models import wpe as j_wpe
from egregora_tpu.nodes import enhance_extras as j_node
from egregora_tpu_torch.models import wpe as t_wpe
from egregora_tpu_torch.nodes import enhance_extras as t_node

WAVE = 1e-3


def reverberant(seconds, sr, channels=2, seed=0, rt=0.3):
    """Seeded tones and noise bursts through a synthetic exponential-decay
    room response per channel."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    dry = (0.3 * np.sin(2 * np.pi * 300 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
           + 0.1 * rng.standard_normal(n) * (np.sin(2 * np.pi * 1.3 * t) > 0.5))
    k = int(rt * sr)
    out = []
    for _ in range(channels):
        h = rng.standard_normal(k) * np.exp(-6.9 * np.arange(k) / k)
        h[0] = 1.0
        h /= np.abs(h).sum() / 3.0
        out.append(np.convolve(dry, h)[:n])
    x = np.stack(out)
    return (0.5 * x / np.abs(x).max()).astype(np.float32)


def test_stack_taps():
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((5, 2, 40)) + 1j * rng.standard_normal((5, 2, 40))).astype(np.complex64)
    for taps, delay in ((10, 3), (3, 1), (4, 16)):
        ref = np.asarray(j_wpe._stack_taps(jnp.asarray(y), taps, delay))
        got = t_wpe._stack_taps(torch.from_numpy(y), taps, delay).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("taps,delay,iters", [(10, 3, 3), (4, 2, 1)])
def test_wpe_matches_jax(taps, delay, iters):
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((33, 2, 120)) + 1j * rng.standard_normal((33, 2, 120)))
    y = (y * np.exp(-np.arange(120) / 60.0)).astype(np.complex64)
    ref = np.asarray(j_wpe.wpe(jnp.asarray(y), taps=taps, delay=delay, iterations=iters))
    got = t_wpe.wpe(torch.from_numpy(y), taps=taps, delay=delay, iterations=iters).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_wpe_dereverb_matches_jax():
    x = reverberant(1.0, 16000)
    kw = dict(taps=10, delay=3, iterations=3, n_fft=256, hop=64)
    ref = np.asarray(j_wpe.wpe_dereverb(jnp.asarray(x), **kw))
    got = t_wpe.wpe_dereverb(torch.from_numpy(x), **kw).numpy()
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= WAVE
    assert np.abs(got - x).max() > 100 * WAVE          # it did something


def _batch2(secs=0.3, sr=16000):
    wf = np.stack([reverberant(secs, sr, seed=s) for s in (2, 3)])     # [2, 2, T]
    return {"waveform": torch.from_numpy(wf), "sample_rate": sr}, wf


def test_node_batch_matches_per_item(monkeypatch):
    """The mic array is each item's C channels: B = 2 through the node
    equals per-item calls, and the JAX node."""
    monkeypatch.setattr(t_node.Egregora_WPE_Dereverb, "DEVICE", "cpu")
    batch, wf = _batch2()
    kw = dict(taps=4, delay=2, iterations=1, n_fft=512, hop=128)
    (out,) = t_node.Egregora_WPE_Dereverb().execute(batch, **kw)
    (ref,) = j_node.Egregora_WPE_Dereverb().execute(batch, **kw)
    got = out["waveform"].numpy()
    assert got.shape == wf.shape and out["meta"] == ref["meta"]
    assert np.abs(got - np.asarray(ref["waveform"])).max() <= WAVE
    for i in range(2):
        item = {"waveform": torch.from_numpy(wf[i: i + 1]), "sample_rate": 16000}
        (one,) = t_node.Egregora_WPE_Dereverb().execute(item, **kw)
        assert np.abs(got[i] - one["waveform"].numpy()[0]).max() <= 1e-5


def test_node_defaults_and_passthrough(monkeypatch, capsys):
    monkeypatch.setattr(t_node.Egregora_WPE_Dereverb, "DEVICE", "cpu")
    x = reverberant(0.5, 48000, seed=4)
    audio = {"waveform": torch.from_numpy(x[None]), "sample_rate": 48000}
    (out,) = t_node.Egregora_WPE_Dereverb().execute(audio)
    (ref,) = j_node.Egregora_WPE_Dereverb().execute(audio)
    direct = t_wpe.wpe_dereverb(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out["waveform"].numpy()[0], direct)
    assert np.abs(out["waveform"].numpy() - np.asarray(ref["waveform"])).max() <= WAVE
    assert out["meta"]["wpe"] == {"taps": 10, "delay": 3, "iterations": 3, "n_fft": 1024,
                                  "hop": 256}

    def fail(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(t_wpe, "wpe_dereverb", fail)
    (out,) = t_node.Egregora_WPE_Dereverb().execute(audio)
    assert "WPE processing failed: planted" in capsys.readouterr().out
    np.testing.assert_array_equal(out["waveform"].numpy()[0], x)
